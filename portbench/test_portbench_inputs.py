"""The device R-MAT generator and the traffic generator, on the CPU."""
import numpy as np
import pytest
import torch

from portbench import loadgen
from portbench.inputs import rmat

CFG = {"scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19,
       "weight_range": [1, 65535], "structure_seed": 5, "search_keys": 64}


@pytest.fixture(scope="module")
def graph():
    return rmat.make_graph(CFG, 2**31 + 7, "cpu")


def test_counts_ranges_and_order(graph):
    edges, keys = graph
    n = 1 << CFG["scale"]
    assert edges.num_vertices == n
    assert 0.5 * 16 * n < edges.num_edges <= 16 * n
    for a in (edges.src, edges.dst):
        assert a.dtype == np.int64 and a.min() >= 0 and a.max() < n
    w = edges.weight
    assert w.dtype == np.float32 and w.min() >= 1 and w.max() <= 65535
    assert np.array_equal(w, np.round(w))
    assert not np.any(edges.src == edges.dst)
    key = edges.src * n + edges.dst
    assert np.all(np.diff(key) > 0)          # (src, dst) order, no repeats


def test_search_keys(graph):
    edges, keys = graph
    assert len(keys) == 64 and len(set(keys.tolist())) == 64
    deg = np.bincount(edges.src, minlength=edges.num_vertices)
    assert np.all(deg[keys] >= 1)


def test_same_seed_same_edges(graph):
    edges, keys = graph
    again, keys2 = rmat.make_graph(CFG, 2**31 + 7, "cpu")
    for a, b in ((edges.src, again.src), (edges.dst, again.dst),
                 (edges.weight, again.weight), (keys, keys2)):
        assert np.array_equal(a, b)


def test_other_seed_relabels_the_same_graph(graph):
    edges, _ = graph
    other, _ = rmat.make_graph(CFG, 11, "cpu")
    assert other.num_edges == edges.num_edges
    assert not np.array_equal(other.src, edges.src)
    n = edges.num_vertices
    for a, b in ((edges.src, other.src), (edges.dst, other.dst)):
        assert np.array_equal(np.sort(np.bincount(a, minlength=n)),
                              np.sort(np.bincount(b, minlength=n)))
    assert np.array_equal(np.sort(edges.weight), np.sort(other.weight))


def test_quadrant_shares():
    """One bit of R-MAT: (src, dst) bits fall in the quadrants a, b, c, d."""
    gen = rmat.generator(3, "cpu")
    src, dst, _ = rmat.rmat_draw(1, 200_000, 0.57, 0.19, 0.19, (1, 9), gen,
                                 "cpu")
    share = torch.bincount(src * 2 + dst, minlength=4).double() / src.numel()
    assert torch.allclose(share, torch.tensor([0.57, 0.19, 0.19, 0.05],
                                              dtype=torch.float64),
                          atol=0.005)


def test_dedup_keeps_first_drawn():
    src = torch.tensor([2, 0, 2, 1, 1, 2])
    dst = torch.tensor([1, 1, 1, 1, 0, 1])
    w = torch.tensor([5.0, 6.0, 7.0, 8.0, 9.0, 10.0])
    s, d, ww = rmat.dedup(src, dst, w, 3)
    assert s.tolist() == [0, 1, 2] and d.tolist() == [1, 0, 1]
    assert ww.tolist() == [6.0, 9.0, 5.0]


def test_closed_loop_blocks():
    mix = {"loop": "closed", "clients": 4, "kinds": {"bfs": 0.5,
                                                     "sssp": 0.5},
           "block": 8}
    keys = np.arange(100, 108)
    roots = {"bfs": True, "sssp": True}
    a = loadgen.ClosedLoop(mix, keys, 9, roots)
    b = loadgen.ClosedLoop(mix, keys, 9, roots)
    qa = [a.next_query() for _ in range(24)]
    assert qa == [b.next_query() for _ in range(24)]
    blocks = [sorted(qa[i:i + 8]) for i in (0, 8, 16)]
    assert blocks[0] == blocks[2] != blocks[1]
    assert sum(k == "bfs" for k, _ in qa[:8]) == 4
    c = loadgen.ClosedLoop(mix, keys, 10, roots)
    qc = [c.next_query() for _ in range(24)]
    assert qc != qa
    assert [sorted(qc[i:i + 8]) for i in (0, 8, 16)] == blocks
    with pytest.raises(ValueError):
        loadgen.ClosedLoop(dict(mix, loop="open"), keys, 9, roots)


@pytest.mark.parametrize("shares", [{"bfs": 0.5, "sssp": 0.5},
                                    {"bfs": 0.25, "sssp": 0.75}])
def test_every_kind_takes_every_key(shares):
    """A kind's keys do not depend on the other kinds of the mix: over
    enough blocks each kind is sent from every key, equally often."""
    mix = {"loop": "closed", "clients": 1, "kinds": shares, "block": 8}
    keys = np.arange(100, 108)
    gen = loadgen.ClosedLoop(mix, keys, 2**31 + 3,
                             {"bfs": True, "sssp": True})
    qs = [gen.next_query() for _ in range(8 * 8)]
    for kind, share in shares.items():
        got = sorted(r for k, r in qs if k == kind)
        assert got == sorted(list(range(100, 108)) * round(share * 8))
