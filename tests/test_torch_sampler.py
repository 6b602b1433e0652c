"""The port's neighbor sampler (`repro_torch.graph.sampler`) and
`coo_to_csr` against the JAX package's: the cases of
`tests/test_sampler.py`, and every array byte-equal to JAX's for the same
graph, fanout and `(seed, step, rank)`."""
import numpy as np
import pytest

from repro.graph.generators import rmat_edges as jrmat
from repro.graph.sampler import NeighborSampler as JaxSampler
from repro.graph.structures import coo_to_csr as jcoo_to_csr
from repro_torch.graph.generators import rmat_edges
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.graph.structures import coo_to_csr


def test_sampler_budgets_and_validity():
    g = rmat_edges(scale=9, edge_factor=8, seed=0).dedup()
    s = NeighborSampler(g, fanout=(5, 3), seed=1)
    sub = s.sample(n_seeds=16, step=0)
    n_pad, e_pad = s.budget(16)
    assert sub.node_ids.shape == (n_pad,)
    assert sub.src.shape == sub.dst.shape == (e_pad,)
    assert sub.num_nodes <= n_pad and sub.num_edges <= e_pad
    # every sampled edge is a real edge of the graph
    real = set(zip(g.src.tolist(), g.dst.tolist()))
    ids = sub.node_ids
    for a, b, ok in zip(sub.src, sub.dst, sub.edge_mask):
        if ok:
            assert (int(ids[a]), int(ids[b])) in real
    # fanout respected: each node receives at most f1 in-edges per hop
    deg = np.bincount(sub.dst[sub.edge_mask], minlength=len(ids))
    assert deg.max() <= 5
    # edges are dst-sorted (the combine key)
    d = sub.dst[sub.edge_mask]
    assert np.all(np.diff(d) >= 0)
    # seeds are included and marked
    assert sub.seed_mask.sum() == 16


def test_sampler_deterministic_and_rank_independent():
    g = rmat_edges(scale=8, edge_factor=8, seed=0).dedup()
    s = NeighborSampler(g, fanout=(4, 2), seed=7)
    a = s.sample(8, step=3, rank=1)
    b = s.sample(8, step=3, rank=1)
    np.testing.assert_array_equal(a.node_ids, b.node_ids)
    np.testing.assert_array_equal(a.src, b.src)
    c = s.sample(8, step=3, rank=2)
    assert not np.array_equal(a.node_ids, c.node_ids)


def test_sampler_batch_stacks():
    g = rmat_edges(scale=8, edge_factor=8, seed=0).dedup()
    s = NeighborSampler(g, fanout=(4, 2), seed=7)
    batch = s.batch(8, step=0, world=4)
    n_pad, e_pad = s.budget(8)
    assert batch["src"].shape == (4, e_pad)
    assert batch["node_ids"].shape == (4, n_pad)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("by", ["src", "dst"])
def test_coo_to_csr_byte_equal(by):
    g = rmat_edges(scale=9, edge_factor=8, seed=2)
    got = coo_to_csr(g.src, g.dst, g.num_vertices, by=by)
    want = jcoo_to_csr(g.src, g.dst, g.num_vertices, by=by)
    assert got.num_vertices == want.num_vertices
    for field in ("indptr", "indices", "edge_ids"):
        _same(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(got.neighbors(3), want.neighbors(3))


@pytest.mark.parametrize("fanout,seeds,seed", [((5, 3), 16, 1),
                                               ((15, 10), 32, 0),
                                               ((4, 2, 2), 8, 9)])
def test_sampler_byte_equal_to_jax(fanout, seeds, seed):
    g = rmat_edges(scale=10, edge_factor=8, seed=3).dedup()
    jg = jrmat(scale=10, edge_factor=8, seed=3).dedup()
    ours, theirs = NeighborSampler(g, fanout, seed), JaxSampler(jg, fanout,
                                                                seed)
    assert ours.budget(seeds) == theirs.budget(seeds)
    for step, rank in ((0, 0), (3, 1), (7, 2)):
        a, b = ours.sample(seeds, step, rank), theirs.sample(seeds, step,
                                                             rank)
        for field in ("node_ids", "src", "dst", "edge_mask", "seed_mask"):
            _same(getattr(a, field), getattr(b, field))
        assert (a.num_nodes, a.num_edges) == (b.num_nodes, b.num_edges)
    for k, v in ours.batch(seeds, 2, 3).items():
        _same(v, theirs.batch(seeds, 2, 3)[k])
