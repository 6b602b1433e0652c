"""The port's host-side partitioners (`repro_torch.core.partition`,
`partition_stream`) against the JAX package's on the same R-MAT graphs:
placements, owners, quality figures and loader state byte-identical, dtypes
included."""
import numpy as np
import pytest

from repro.core import partition as jpart
from repro.core import partition_stream as jstream
from repro.graph.structures import Graph as JaxGraph
from repro_torch.core import partition as tpart
from repro_torch.core import partition_stream as tstream
from repro_torch.graph.generators import rmat_edges

from torch_parity import to_graph

KS = (2, 4, 8)


@pytest.fixture(scope="module", params=[8, 10], ids=["s8", "s10"])
def graphs(request):
    g = rmat_edges(scale=request.param, edge_factor=8, seed=request.param,
                   weights=True).dedup()
    return g, to_graph(g, JaxGraph)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("k", KS)
def test_hash_partition(graphs, k):
    g, jg = graphs
    _same(tpart.hash_partition(g, k, seed=3), jpart.hash_partition(jg, k,
                                                                   seed=3))


@pytest.mark.parametrize("batch", [1, 16, 256])
@pytest.mark.parametrize("k", KS)
def test_greedy_partition(graphs, k, batch):
    g, jg = graphs
    if batch == 1 and g.num_vertices > 256:
        g, jg = (x.__class__(x.num_vertices, x.src[:3000], x.dst[:3000])
                 for x in (g, jg))
    _same(tpart.greedy_partition(g, k, batch_size=batch, seed=1),
          jpart.greedy_partition(jg, k, batch_size=batch, seed=1))


@pytest.mark.parametrize("lam", [0.0, 1.0, 8.0])
@pytest.mark.parametrize("k", KS)
def test_hdrf_partition(graphs, k, lam):
    g, jg = graphs
    ts, js = {}, {}
    _same(tstream.hdrf_partition(g, k, lam=lam, chunk_size=1000, stats=ts),
          jstream.hdrf_partition(jg, k, lam=lam, chunk_size=1000, stats=js))
    assert ts == js


@pytest.mark.parametrize("method", ["hdrf", "greedy", "hash"])
def test_partition_edges_registry(graphs, method):
    g, jg = graphs
    _same(tstream.partition_edges(g, 4, method=method),
          jstream.partition_edges(jg, 4, method=method))
    with pytest.raises(ValueError, match="unknown partitioner"):
        tstream.partition_edges(g, 4, method="metis")


@pytest.mark.parametrize("k", KS)
def test_owners_and_quality(graphs, k):
    g, jg = graphs
    part = tstream.partition_edges(g, k)
    owner = tpart.assign_owners(g, part, k)
    _same(owner, jpart.assign_owners(jg, part, k))
    cap = -(-g.num_vertices // k) + 8
    _same(tpart.rebalance_owners(owner, k, cap),
          jpart.rebalance_owners(owner, k, cap))
    assert (tpart.partition_quality(g, part, k=k, partitioner_state_bytes=7)
            .as_dict()
            == jpart.partition_quality(jg, part, k=k,
                                       partitioner_state_bytes=7).as_dict())


def test_merge_loader_states_and_edge_cut(graphs):
    g, jg = graphs
    _same(tpart.hash_edge_cut(g, 4), jpart.hash_edge_cut(jg, 4))
    rng = np.random.default_rng(0)

    def states():
        r = np.random.default_rng(0)
        return [{"has_src": r.integers(0, 2**63, (4, 5), dtype=np.uint64),
                 "has_dst": r.integers(0, 2**63, (4, 5), dtype=np.uint64),
                 "ne": r.integers(10, 99, 4).astype(np.int64)}
                for _ in range(3)]
    base = rng.integers(0, 9, 4).astype(np.int64)
    ts, js = states(), states()
    _same(tpart.merge_loader_states(ts, base, 3),
          jpart.merge_loader_states(js, base, 3))
    for a, b in zip(ts, js):
        for key in a:
            _same(a[key], b[key])


# the rebalance edge cases of tests/test_partition.py (the infeasible one
# is test_rebalance_rejects_infeasible)
REBALANCE_CASES = {
    "all_at_cap": (np.repeat(np.arange(4, dtype=np.int32), 8), 4, 8),
    "drain_to_cap": (np.zeros(32, dtype=np.int32), 4, 8),
    "random": (np.random.default_rng(7).integers(0, 5, 97).astype(np.int32),
               5, 21),
}


@pytest.mark.parametrize("case", sorted(REBALANCE_CASES))
def test_rebalance_edge_cases(case):
    owner, k, cap = REBALANCE_CASES[case]
    _same(tpart.rebalance_owners(owner, k, cap),
          jpart.rebalance_owners(owner, k, cap))


def test_rebalance_rejects_infeasible():
    for mod in (tpart, jpart):
        with pytest.raises(ValueError, match="cannot rebalance"):
            mod.rebalance_owners(np.zeros(9, np.int32), 2, 4)


def test_assign_owners_ties_break_lowest():
    src, dst, part = np.array([0, 1]), np.array([2, 2]), np.array([1, 0])
    t = tpart.assign_owners(tpart.Graph(3, src, dst), part, 2)
    _same(t, jpart.assign_owners(JaxGraph(3, src, dst), part, 2))
    assert t[2] == 0


@pytest.mark.parametrize("bits", [1, 63, 64, 130])
def test_bitset_helpers(bits):
    rng = np.random.default_rng(bits)
    rows = rng.integers(0, 50, 200)
    bit = rng.integers(0, bits, 200)
    tb, jb = tstream.make_bitset(50, bits), jstream.make_bitset(50, bits)
    _same(tb, jb)
    tstream.bitset_set(tb, rows, bit)
    jstream.bitset_set(jb, rows, bit)
    _same(tb, jb)
    _same(tstream.bitset_rows(tb, rows[:17], bits),
          jstream.bitset_rows(jb, rows[:17], bits))
    assert tstream.bitset_popcount(tb) == jstream.bitset_popcount(jb)
    for v, k in ((100, bits), (1 << 20, 8)):
        assert tstream.hdrf_state_bytes(v, k) == jstream.hdrf_state_bytes(v, k)
        assert (tstream.greedy_state_bytes(v, k, 3)
                == jstream.greedy_state_bytes(v, k, 3))
