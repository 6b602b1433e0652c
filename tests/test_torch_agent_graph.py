"""The port's Agent-Graph ingress (`repro_torch.core.agent_graph`) against
the JAX package's on the same graphs and placements: every field of
`AgentGraph`, every tile of `split_edge_tiles` and `slot_to_original`
byte-identical, dtypes included."""
import dataclasses

import numpy as np
import pytest

from repro.core import agent_graph as jag
from repro.core import partition_stream as jstream
from repro.graph.structures import Graph as JaxGraph
from repro_torch.core import agent_graph as tag
from repro_torch.core import partition_stream as tstream
from repro_torch.graph.generators import rmat_edges

from torch_parity import to_graph


@pytest.fixture(scope="module")
def graphs():
    g = rmat_edges(scale=9, edge_factor=8, seed=4, weights=True).dedup()
    return g, to_graph(g, JaxGraph)


def assert_same(a, b, where=""):
    """Dataclasses, dicts, arrays and scalars equal field by field, arrays
    with equal dtypes."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for key in a:
            assert_same(a[key], b[key], f"{where}[{key}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("method", ["hash", "greedy", "hdrf"])
def test_agent_graph_equal(graphs, method, k):
    g, jg = graphs
    part = tstream.partition_edges(g, k, method=method)
    assert_same(tag.build_agent_graph(g, part, k),
                jag.build_agent_graph(jg, part, k))


@pytest.mark.parametrize("method", ["hash", "greedy", "hdrf"])
def test_agent_graph_by_name_and_chunked(graphs, method):
    """A partitioner name is dispatched and recorded as in JAX; any chunk
    size builds the monolithic graph."""
    g, jg = graphs
    mono = tag.build_agent_graph(g, method, 4)
    assert mono.partitioner == method
    assert_same(mono, jag.build_agent_graph(jg, method, 4))
    part = tstream.partition_edges(g, 4, method=method)
    for chunk in (97, 1000):
        assert_same(tag.build_agent_graph(g, method, 4, chunk_size=chunk),
                    mono)
        from_source = tag.build_agent_graph(g.chunk_source(chunk), part, 4)
        assert_same(from_source, dataclasses.replace(mono, partitioner=""))


@pytest.mark.parametrize("chunk", [None, 333])
def test_agent_graph_transpose(graphs, chunk):
    g, jg = graphs
    part = tstream.partition_edges(g, 4)
    assert_same(tag.build_agent_graph(g, part, 4, transpose=True,
                                      chunk_size=chunk),
                jag.build_agent_graph(jg, part, 4, transpose=True,
                                      chunk_size=chunk))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_split_edge_tiles_and_slot_map(graphs, k):
    g, jg = graphs
    part = tstream.partition_edges(g, k, method="greedy")
    t = tag.build_agent_graph(g, part, k)
    j = jag.build_agent_graph(jg, part, k)
    split, jsplit = tag.split_edge_tiles(t), jag.split_edge_tiles(j)
    assert_same(split, jsplit)
    assert isinstance(split.remote_fraction, float)
    assert_same(tag.split_edge_tiles(t, pad_multiple=32),
                jag.split_edge_tiles(j, pad_multiple=32))
    assert_same(tag.slot_to_original(t), jag.slot_to_original(j))


@pytest.mark.parametrize("k", [3, 8])
def test_split_edge_tiles_of_held_shards(graphs, k):
    """A process that holds one shard (or a block of them) builds only its
    rows of the tiles, each bitwise the whole split's row, with the whole
    split's pads, maxima and remote fraction; the engine's rank topology
    is laid out from them."""
    g, _ = graphs
    t = tag.build_agent_graph(g, tstream.partition_edges(g, k, "hdrf"), k)
    whole = tag.split_edge_tiles(t)
    for shards in [range(i, i + 1) for i in range(k)] + [range(1, k)]:
        held = tag.split_edge_tiles(t, shards=shards)
        assert held.remote_fraction == whole.remote_fraction
        for name in ("remote", "local"):
            a, b = getattr(held, name), getattr(whole, name)
            rows = slice(shards.start, shards.stop)
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(y, np.ndarray):
                    assert_same(x, y[rows], f"{name}.{f.name}")
                elif isinstance(y, dict):
                    assert_same(x, {n: v[rows] for n, v in y.items()},
                                f"{name}.{f.name}")
                else:
                    assert_same(x, y, f"{name}.{f.name}")


def test_edge_part_length_mismatch_raises(graphs):
    g, _ = graphs
    with pytest.raises(ValueError, match="entries"):
        tag.build_agent_graph(g, np.zeros(3, np.int64), 2)


def test_partition_edges_same_as_jax_hdrf(graphs):
    g, jg = graphs
    assert np.array_equal(tstream.partition_edges(g, 8),
                          jstream.partition_edges(jg, 8))


# ------------------------------------------------------------ delta ingress
@pytest.mark.parametrize("frac", [0.01, 0.05])
@pytest.mark.parametrize("method,pad,compacted", [("hdrf", 64, False),
                                                  ("hash", 8, True)])
def test_apply_edge_delta_equal(graphs, method, pad, compacted, frac):
    """`apply_edge_delta` equals the JAX package's byte for byte at k = 4:
    on HDRF shards with slack in their pads (the fast path: tombstones,
    adds on owner(dst), fresh scatter agents and their exchange pairs),
    and on the hash partition's tight pads (the compaction path, which
    keeps `old2new`)."""
    from repro.core.agent_graph import apply_edge_delta as japply
    from repro.graph.structures import EdgeDelta as JaxDelta
    from repro_torch.graph.structures import EdgeDelta
    from torch_parity import mutation_delta, report_arrays
    g, jg = graphs
    part = tstream.partition_edges(g, 4, method=method)
    t = tag.build_agent_graph(g, part, 4, pad_multiple=pad)
    j = jag.build_agent_graph(jg, part, 4, pad_multiple=pad)
    fields = mutation_delta(g, seed=5, frac=frac)
    new, rep = tag.apply_edge_delta(t, EdgeDelta(**fields))
    jnew, jrep = japply(j, JaxDelta(**fields))
    assert_same(new, jnew)
    a, b = report_arrays(rep), report_arrays(jrep)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    assert rep.compacted == compacted
    assert np.array_equal(new.old2new, t.old2new)
    if not compacted:   # new agents and pairs were appended in the slack
        assert new.num_scatter.sum() > t.num_scatter.sum()
        assert_same(tag.split_edge_tiles(new), jag.split_edge_tiles(jnew))
    # a second delta on the mutated graph
    fields2 = mutation_delta(g.apply_edge_delta(EdgeDelta(**fields)),
                             seed=6, frac=frac / 2)
    assert_same(tag.apply_edge_delta(new, EdgeDelta(**fields2))[0],
                japply(jnew, JaxDelta(**fields2))[0])
