"""The port's incremental re-convergence against the JAX package on the same
numpy inputs: the taint and seeding masks (`repro_torch.core.incremental`),
the delta ingress (`Graph.apply_edge_delta`,
`DevicePartition.apply_edge_delta`), the chunked `from_graph`, the
validation errors, and warm == cold after a delta.

Tolerances: masks, partitions, reports and errors are byte-identical (the
same host numpy code, with faster formulations of the same sets); BFS, SSSP
and CC warm results are bitwise equal to the JAX package's cold single-shard
result on the mutated graph (min programs of exact f32 sums); PageRank's
warm start lands within atol 2e-3 of the cold run, the JAX package's own
tolerance for it (tests/test_incremental.py).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import algorithms as jalg
from repro.core import incremental as jinc
from repro.core.agent_graph import apply_edge_delta as jax_ag_apply
from repro.core.agent_graph import build_agent_graph as jax_build
from repro.core.engine import DevicePartition as JaxPartition
from repro.core.engine import GREEngine as JaxEngine
from repro.core.partition import greedy_partition as jax_greedy
from repro.graph.structures import EdgeDelta as JaxDelta
from repro.graph.structures import Graph as JaxGraph
from repro_torch.core import algorithms
from repro_torch.core import incremental as inc
from repro_torch.core.agent_graph import apply_edge_delta as ag_apply
from repro_torch.core.agent_graph import build_agent_graph
from repro_torch.core.engine import DevicePartition, GREEngine
from repro_torch.graph.generators import barabasi_albert_graph, rmat_edges
from repro_torch.graph.structures import EdgeDelta, Graph
from repro_torch.kernels.segment_combine import segment_row_pointer

from torch_parity import (edge_delta, mutation_delta, partition_arrays,
                          report_arrays, to_graph)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # benchmarks

MULTI = [0, 3, 17]
PROGRAMS = {   # name -> (port factory, JAX factory, source, undirected)
    "bfs": (algorithms.bfs_program, jalg.bfs_program, 0, False),
    "sssp_x3": (lambda: algorithms.sssp_program(3),
                lambda: jalg.sssp_program(3), MULTI, False),
    "cc": (algorithms.cc_program, jalg.cc_program, None, True),
}
PARTS = {"both": ("add", "rem"), "adds": ("add",), "removals": ("rem",)}


def _fix(x):
    return np.nan_to_num(np.asarray(x), posinf=-1.0)


@pytest.fixture(scope="module")
def graphs():
    g = rmat_edges(scale=6, edge_factor=4, seed=11, weights=True).dedup()
    gu = rmat_edges(scale=6, edge_factor=4, seed=5).dedup().as_undirected()
    return {False: g, True: gu}


def _delta_fields(graphs, undirected):
    return mutation_delta(graphs[undirected], seed=33 if undirected else 21,
                          undirected=undirected)


def assert_partitions_equal(port, jax_part):
    """Every field of the two partitions equal, dtypes included."""
    pa, ps = partition_arrays(port)
    ja, js = partition_arrays(jax_part)
    assert ps == js
    for key in ja:
        if isinstance(ja[key], dict):
            assert sorted(pa[key]) == sorted(ja[key]), key
            for name in ja[key]:
                a, b = pa[key][name], ja[key][name]
                assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            a, b = pa[key], ja[key]
            assert a.dtype == b.dtype and np.array_equal(a, b), key


def assert_reports_equal(port, jax_report):
    a, b = report_arrays(port), report_arrays(jax_report)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


# ------------------------------------------------------------ the masks
@pytest.mark.parametrize("parts", sorted(PARTS))
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_masks_equal_jax(graphs, name, parts):
    """`compute_taint`, `warm_seed_active` and `source_mask` on the JAX
    package's own fixed point, delta report and mutated live edges."""
    _, jmk, source, undirected = PROGRAMS[name]
    mk = PROGRAMS[name][0]
    jg = to_graph(graphs[undirected], JaxGraph)
    fields = _delta_fields(graphs, undirected)
    jpart = JaxPartition.from_graph(jg)
    jeng = JaxEngine(jmk())
    prev = np.asarray(jeng.run(jpart, jeng.init_state(jpart, source=source),
                               300).vertex_data)
    new, report = jpart.apply_edge_delta(
        edge_delta(JaxDelta, fields, PARTS[parts]))
    mask = np.asarray(new.edge_mask)
    lsrc = np.asarray(new.src)[mask].astype(np.int64)
    ldst = np.asarray(new.dst)[mask].astype(np.int64)
    jp, tp = jmk(), mk()
    eprop = (np.asarray(new.edge_props[jp.needs_edge_prop])[mask]
             if jp.needs_edge_prop else None)
    n = new.num_masters
    protected = inc.source_mask(prev.shape, source)
    assert np.array_equal(protected, jinc.source_mask(prev.shape, source))
    want = jinc.compute_taint(jp, n, lsrc, ldst, eprop, prev, report,
                              protected)
    got = inc.compute_taint(tp, n, lsrc, ldst, eprop, prev, report,
                            protected)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if parts != "adds":
        assert want.any(), "the delta should taint something"
    tany = want if want.ndim == 1 else want.any(axis=-1)
    init_act = np.asarray(jp.init_active(n, new.aux))
    args = (n, lsrc, ldst, tany, report.added_src, init_act)
    assert np.array_equal(inc.warm_seed_active(*args),
                          jinc.warm_seed_active(*args))


def test_reach_taint_equals_jax(graphs):
    """The component policy's reachability alone, from a few seeds."""
    g = graphs[True]
    seeds = np.array([1, 7, 7, 30])
    for s in (seeds, seeds[:0]):
        assert np.array_equal(
            inc.reach_taint(g.num_vertices, g.src, g.dst, s),
            jinc.reach_taint(g.num_vertices, g.src, g.dst, s))


def test_check_supported_refusals_equal_jax(graphs):
    """Both packages refuse the same programs with the same message."""
    g = graphs[False]
    fields = _delta_fields(graphs, False)
    report = JaxPartition.from_graph(to_graph(g, JaxGraph)).apply_edge_delta(
        edge_delta(JaxDelta, fields))[1]
    adds = dataclasses.replace(report, removed_src=report.removed_src[:0],
                               removed_dst=report.removed_dst[:0])
    cases = [(algorithms.ppr_push_program(2), jalg.ppr_push_program(2),
              report),
             (dataclasses.replace(algorithms.bfs_program(),
                                  invalidation=None),
              dataclasses.replace(jalg.bfs_program(), invalidation=None),
              report)]
    for prog, jprog, rep in cases:
        with pytest.raises(ValueError) as want:
            jinc.check_supported(jprog, rep)
        with pytest.raises(ValueError) as got:
            inc.check_supported(prog, rep)
        assert str(got.value) == str(want.value)
    # adds only need no invalidation policy; iterative programs always pass
    inc.check_supported(cases[1][0], adds)
    inc.check_supported(algorithms.pagerank_program(), report)


# ------------------------------------------------------- delta ingress
@pytest.mark.parametrize("case", ["slack", "compaction", "removals", "empty"])
def test_partition_delta_equals_jax(graphs, case):
    """`DevicePartition.apply_edge_delta` (device "cpu") equals the JAX
    package's field by field, with its report; the row pointer is rebuilt
    over the new dst (the sink's segment counts the tombstones)."""
    g = graphs[False]
    jg = to_graph(g, JaxGraph)
    fields = _delta_fields(graphs, False)
    slack = {"slack": 64, "compaction": 0, "removals": 0, "empty": 0}[case]
    parts = {"removals": ("rem",), "empty": ()}.get(case, ("add", "rem"))
    if case == "compaction":   # more adds than removals: the slack runs out
        fields = dict(fields, rem_src=fields["rem_src"][:4],
                      rem_dst=fields["rem_dst"][:4])
    part = DevicePartition.from_graph(g, edge_slack=slack, device="cpu")
    jpart = JaxPartition.from_graph(jg, edge_slack=slack)
    new, report = part.apply_edge_delta(edge_delta(EdgeDelta, fields, parts))
    jnew, jreport = jpart.apply_edge_delta(edge_delta(JaxDelta, fields,
                                                      parts))
    assert_partitions_equal(new, jnew)
    assert_reports_equal(report, jreport)
    assert report.compacted == (case == "compaction")
    assert new.seg_ptr.dtype == new.dst.dtype
    assert np.array_equal(new.seg_ptr.numpy(), segment_row_pointer(
        new.dst, new.num_slots).numpy())
    tomb = int(new.seg_ptr[-1] - new.seg_ptr[-2])
    assert tomb == int((~new.edge_mask).sum())
    # a second delta over the mutated partition, and the COO-level graph
    g2 = g.apply_edge_delta(edge_delta(EdgeDelta, fields, parts))
    jg2 = jg.apply_edge_delta(edge_delta(JaxDelta, fields, parts))
    assert np.array_equal(g2.src, jg2.src) and np.array_equal(g2.dst,
                                                              jg2.dst)
    assert np.array_equal(g2.edge_props["weight"], jg2.edge_props["weight"])


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("chunk", [97, 1000])
def test_chunked_from_graph_equals_monolithic(graphs, chunk, transpose):
    """`from_graph(chunk_size=)` and from an `EdgeChunkSource` equal the
    monolithic build bitwise, and the JAX package's chunked build."""
    g = graphs[False]
    kw = dict(transpose=transpose, edge_slack=5, device="cpu")
    mono = DevicePartition.from_graph(g, **kw)
    for built in (DevicePartition.from_graph(g, chunk_size=chunk, **kw),
                  DevicePartition.from_graph(g.chunk_source(chunk), **kw)):
        assert_partitions_equal(built, JaxPartition.from_graph(
            to_graph(g, JaxGraph), chunk_size=chunk, transpose=transpose,
            edge_slack=5))
        assert_partitions_equal(built, JaxPartition.from_graph(
            to_graph(g, JaxGraph), transpose=transpose, edge_slack=5))
        assert np.array_equal(built.seg_ptr.numpy(), mono.seg_ptr.numpy())


def _apply_paths(g, jg):
    """The three delta-ingress surfaces of each package on the same graph:
    the Graph rebuild, the single-shard partition and the agent graph."""
    jag = jax_build(jg, jax_greedy(jg, 2, batch_size=16), 2)
    ag = build_agent_graph(g, jax_greedy(jg, 2, batch_size=16), 2)
    return {
        "graph": (lambda d: g.apply_edge_delta(d),
                  lambda d: jg.apply_edge_delta(d)),
        "part": (lambda d: DevicePartition.from_graph(
                     g, device="cpu").apply_edge_delta(d),
                 lambda d: JaxPartition.from_graph(jg).apply_edge_delta(d)),
        "agent": (lambda d: ag_apply(ag, d), lambda d: jax_ag_apply(jag, d)),
    }


def _bad_deltas(g):
    n = g.num_vertices
    live = set(zip(g.src.tolist(), g.dst.tolist()))
    s, d = next((a, b) for a in range(n) for b in range(n)
                if (a, b) not in live)
    return {
        "add_src_range": dict(add_src=[1, n], add_dst=[2, 3],
                              add_props={"weight": [1.0, 1.0]}),
        "add_dst_negative": dict(add_src=[1], add_dst=[-2],
                                 add_props={"weight": [1.0]}),
        "rem_dst_range": dict(rem_src=[int(g.src[0])], rem_dst=[n + 7]),
        "duplicate_adds": dict(add_src=[4, 5, 4], add_dst=[9, 9, 9],
                               add_props={"weight": [1.0, 2.0, 3.0]}),
        "dead_removal": dict(rem_src=[int(g.src[0]), s],
                             rem_dst=[int(g.dst[0]), d]),
        "missing_prop": dict(add_src=[4], add_dst=[9]),
    }


@pytest.mark.parametrize("case", ["add_src_range", "add_dst_negative",
                                  "rem_dst_range", "duplicate_adds",
                                  "dead_removal", "missing_prop"])
@pytest.mark.parametrize("path", ["graph", "part", "agent"])
def test_bad_deltas_fail_as_jax(graphs, path, case):
    """A malformed delta raises the JAX package's exception type with its
    message, on every ingress path."""
    g = graphs[False]
    jg = to_graph(g, JaxGraph)
    port, jax_apply = _apply_paths(g, jg)[path]
    fields = _bad_deltas(g)[case]
    with pytest.raises(Exception) as want:
        jax_apply(JaxDelta(**fields))
    with pytest.raises(type(want.value)) as got:
        port(EdgeDelta(**fields))
    assert str(got.value) == str(want.value)


def test_second_removal_of_a_tombstone_fails(graphs):
    g = graphs[False]
    part = DevicePartition.from_graph(g, device="cpu")
    rem = EdgeDelta(rem_src=[int(g.src[0])], rem_dst=[int(g.dst[0])])
    p2, rep = part.apply_edge_delta(rem)
    assert rep.num_removed >= 1
    with pytest.raises(ValueError, match="no live edge"):
        p2.apply_edge_delta(rem)


# ------------------------------------------------------- warm == cold
@pytest.mark.parametrize("strategy", ["dense", "compact", "auto"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_warm_equals_cold(graphs, name, strategy):
    """`rerun_incremental` lands bitwise on the JAX package's cold result on
    the mutated graph and on its own warm result, on every frontier
    strategy with an explicit `frontier_cap` (tests/test_conformance.py's
    mutation rows on the null backend)."""
    mk, jmk, source, undirected = PROGRAMS[name]
    g = graphs[undirected]
    jg = to_graph(g, JaxGraph)
    fields = _delta_fields(graphs, undirected)
    eng = GREEngine(mk(), frontier=strategy, frontier_cap=32)
    part = DevicePartition.from_graph(g, device="cpu")
    prev = eng.run(part, eng.init_state(part, source=source), 300)
    new, out, report = eng.rerun_incremental(
        part, prev, EdgeDelta(**fields), source=source, max_steps=300)
    jeng = JaxEngine(jmk(), frontier=strategy, frontier_cap=32)
    jpart = JaxPartition.from_graph(jg)
    jprev = jeng.run(jpart, jeng.init_state(jpart, source=source), 300)
    _, jout, _ = jeng.rerun_incremental(jpart, jprev, JaxDelta(**fields),
                                        source=source, max_steps=300)
    cold_part = JaxPartition.from_graph(jg.apply_edge_delta(
        JaxDelta(**fields)))
    cold_eng = JaxEngine(jmk())
    cold = cold_eng.run(cold_part, cold_eng.init_state(cold_part,
                                                       source=source), 300)
    got = out.vertex_data.numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_fix(got), _fix(cold.vertex_data))
    np.testing.assert_array_equal(_fix(got), _fix(jout.vertex_data))
    assert out.step == int(jout.step)
    assert report.num_removed and report.num_adds


def test_empty_delta_is_noop(graphs):
    g = graphs[False]
    eng = GREEngine(algorithms.sssp_program())
    part = DevicePartition.from_graph(g, device="cpu")
    state = eng.run(part, eng.init_state(part, source=0), 300)
    _, out, report = eng.rerun_incremental(part, state, EdgeDelta(),
                                           source=0)
    assert report.num_adds == 0 and report.num_removed == 0
    assert not report.compacted and out.step == 0
    assert np.array_equal(out.vertex_data.numpy(),
                          state.vertex_data.numpy())


def test_pagerank_warm_start_converges_close(graphs):
    """PageRank warm-starts by carrying its values forward (every vertex
    re-scatters) and lands within the JAX package's tolerance of the cold
    run; it equals the JAX package's warm run to float tolerance."""
    g = graphs[False]
    rng = np.random.default_rng(2)
    pick = rng.choice(g.num_edges, size=6, replace=False)
    fields = dict(add_src=rng.integers(0, g.num_vertices, size=6),
                  add_dst=rng.integers(0, g.num_vertices, size=6),
                  add_props={"weight": np.ones(6, np.float32)},
                  rem_src=g.src[pick], rem_dst=g.dst[pick])
    eng = GREEngine(algorithms.pagerank_program(), frontier="dense")
    part = DevicePartition.from_graph(g, device="cpu")
    state = eng.run(part, eng.init_state(part), 50)
    _, out, _ = eng.rerun_incremental(part, state, EdgeDelta(**fields),
                                      max_steps=50)
    cold_part = DevicePartition.from_graph(
        g.apply_edge_delta(EdgeDelta(**fields)), device="cpu")
    cold = eng.run(cold_part, eng.init_state(cold_part), 50)
    np.testing.assert_allclose(out.vertex_data.numpy(),
                               cold.vertex_data.numpy(), rtol=0, atol=2e-3)
    jeng = JaxEngine(jalg.pagerank_program(), frontier="dense")
    jpart = JaxPartition.from_graph(to_graph(g, JaxGraph))
    jstate = jeng.run(jpart, jeng.init_state(jpart), 50)
    _, jout, _ = jeng.rerun_incremental(jpart, jstate, JaxDelta(**fields),
                                        max_steps=50)
    np.testing.assert_allclose(out.vertex_data.numpy(),
                               np.asarray(jout.vertex_data), rtol=1e-5,
                               atol=1e-5)


def test_unsupported_programs_refuse_warm_start(graphs):
    g = graphs[False]
    part = DevicePartition.from_graph(g, device="cpu")
    eng = GREEngine(algorithms.ppr_push_program(2), frontier="dense")
    state = eng.init_state(part, source=[0, 1])
    with pytest.raises(ValueError, match="warm"):
        eng.rerun_incremental(part, state, EdgeDelta(), source=[0, 1])
    stripped = dataclasses.replace(algorithms.bfs_program(),
                                   invalidation=None)
    eng2 = GREEngine(stripped)
    st2 = eng2.run(part, eng2.init_state(part, source=0), 300)
    rem = EdgeDelta(rem_src=g.src[:1], rem_dst=g.dst[:1])
    with pytest.raises(ValueError, match="invalidation"):
        eng2.rerun_incremental(part, st2, rem, source=0)
    add = EdgeDelta(add_src=[1], add_dst=[2], add_props={"weight": [1.0]})
    _, out, _ = eng2.rerun_incremental(part, st2, add, source=0)
    assert np.isfinite(out.vertex_data.numpy()).any()


# --------------------------------------------------------- edge scans
def _scans(eng, part, state, max_steps=600):
    """The port's form of `bench_incremental._run_counted`: the exact edge
    scans of a run, the active masters' out-degrees summed over
    supersteps."""
    out_deg = part.aux["out_degree"].numpy()
    n = part.num_masters
    scans = steps = 0
    while steps < max_steps:
        act = state.active_scatter.numpy()[:n]
        if not act.any():
            break
        scans += int(out_deg[act].sum())
        state = eng.superstep(part, state)
        steps += 1
    return state, scans, steps


def test_edge_scan_count_equals_jax():
    """`bench_incremental`'s headline row (Barabási–Albert scale 11, its 1%
    churn batch, SSSP): the warm run's exact edge scans equal the JAX
    package's, counted by the benchmark's own `_run_counted`, and are at
    least 3x below the cold run's, in no more supersteps.  The count does
    not depend on the hardware."""
    from benchmarks.bench_incremental import _churn, _run_counted
    g = barabasi_albert_graph(1 << 11, m=8, seed=7, weights=True)
    jg = to_graph(g, JaxGraph)
    jdelta = _churn(jg, 0.01, seed=11)
    delta = EdgeDelta(jdelta.add_src, jdelta.add_dst, jdelta.add_props,
                      jdelta.rem_src, jdelta.rem_dst)
    eng = GREEngine(algorithms.sssp_program())
    part = DevicePartition.from_graph(g, device="cpu")
    prev = eng.run(part, eng.init_state(part, source=0), 600)
    new, report = part.apply_edge_delta(delta)
    warm, scans_w, steps_w = _scans(
        eng, new, eng.warm_start_state(new, prev, report, source=0))
    cold, scans_c, steps_c = _scans(eng, new, eng.init_state(new, source=0))
    assert np.array_equal(warm.vertex_data.numpy(), cold.vertex_data.numpy())
    jeng = JaxEngine(jalg.sssp_program())
    jpart = JaxPartition.from_graph(jg)
    jprev = jeng.run(jpart, jeng.init_state(jpart, source=0), 600)
    jnew, jreport = jpart.apply_edge_delta(jdelta)
    jwarm, jscans, jsteps = _run_counted(
        jeng, jnew, jeng.warm_start_state(jnew, jprev, jreport, source=0))
    assert (scans_w, steps_w) == (jscans, jsteps)
    np.testing.assert_array_equal(warm.vertex_data.numpy(),
                                  np.asarray(jwarm.vertex_data))
    assert scans_c >= 3 * scans_w, (scans_c, scans_w)
    assert steps_w <= steps_c


def test_graph_delta_matches_jax_graph():
    """The COO-level `Graph.apply_edge_delta` on a graph with vertex props
    keeps them and matches the JAX package's."""
    g = Graph(5, np.array([0, 1, 2, 2]), np.array([1, 2, 3, 3]),
              {"weight": np.array([1, 2, 3, 4], np.float32)},
              {"label": np.arange(5)})
    d = dict(add_src=[4], add_dst=[0], add_props={"weight": [9.0]},
             rem_src=[2], rem_dst=[3])
    got = g.apply_edge_delta(EdgeDelta(**d))
    want = to_graph(g, JaxGraph).apply_edge_delta(JaxDelta(**d))
    assert np.array_equal(got.src, want.src)
    assert np.array_equal(got.dst, want.dst)
    assert np.array_equal(got.edge_props["weight"], want.edge_props["weight"])
    assert np.array_equal(got.vertex_props["label"], np.arange(5))
