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


def test_edge_part_length_mismatch_raises(graphs):
    g, _ = graphs
    with pytest.raises(ValueError, match="entries"):
        tag.build_agent_graph(g, np.zeros(3, np.int64), 2)


def test_partition_edges_same_as_jax_hdrf(graphs):
    g, jg = graphs
    assert np.array_equal(tstream.partition_edges(g, 8),
                          jstream.partition_edges(jg, 8))
