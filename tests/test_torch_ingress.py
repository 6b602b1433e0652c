"""Host ingress of the PyTorch port vs the JAX package: generators, dedup
and `DevicePartition` columns must be byte-identical for the same seeds."""
import numpy as np
import pytest
import torch

from repro.core.engine import DevicePartition as JaxPartition
from repro.graph import generators as jgen
from repro_torch.core.engine import DevicePartition, EngineState
from repro_torch.graph import generators as tgen
from repro_torch.graph.structures import Graph

from torch_parity import PARTITION_STATICS, partition_arrays, state_arrays

GENERATORS = [
    ("rmat", lambda m: m.rmat_edges(7, 8, seed=3)),
    ("rmat_weighted", lambda m: m.rmat_edges(7, 8, seed=3, weights=True)),
    ("rmat_unpermuted", lambda m: m.rmat_edges(6, 4, seed=5, permute=False)),
    ("ring", lambda m: m.ring_graph(16, weights=True)),
    ("circulant", lambda m: m.circulant_graph(256, 4, weights=True, seed=2)),
    ("barabasi_albert", lambda m: m.barabasi_albert_graph(128, 3, seed=4,
                                                          weights=True)),
    ("erdos_renyi", lambda m: m.erdos_renyi_edges(100, 400, seed=6,
                                                  weights=True)),
]


def _assert_same_graph(a, b):
    assert a.num_vertices == b.num_vertices
    for col in ("src", "dst"):
        x, y = getattr(a, col), getattr(b, col)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), col
    assert sorted(a.edge_props) == sorted(b.edge_props)
    for k in a.edge_props:
        assert a.edge_props[k].dtype == b.edge_props[k].dtype
        assert a.edge_props[k].tobytes() == b.edge_props[k].tobytes(), k


@pytest.mark.parametrize("make", [m for _, m in GENERATORS],
                         ids=[n for n, _ in GENERATORS])
def test_generators_byte_identical(make):
    _assert_same_graph(make(tgen), make(jgen))


@pytest.mark.parametrize("make", [m for _, m in GENERATORS[:2]],
                         ids=[n for n, _ in GENERATORS[:2]])
def test_dedup_and_views_byte_identical(make):
    t, j = make(tgen), make(jgen)
    _assert_same_graph(t.dedup(), j.dedup())
    _assert_same_graph(t.reversed(), j.reversed())
    _assert_same_graph(t.dedup().as_undirected(), j.dedup().as_undirected())
    np.testing.assert_array_equal(t.out_degree(), j.out_degree())
    np.testing.assert_array_equal(t.in_degree(), j.in_degree())


def _assert_same_partition(tpart, jpart):
    ta, ts = partition_arrays(tpart)
    ja, js = partition_arrays(jpart)
    assert ts == js
    for k in ("src", "dst", "edge_mask", "csr_indptr", "csr_eidx",
              "bucket_id"):
        assert ta[k].dtype == ja[k].dtype, k
        assert ta[k].tobytes() == ja[k].tobytes(), k
    for group in ("edge_props", "aux"):
        assert sorted(ta[group]) == sorted(ja[group])
        for k in ta[group]:
            assert ta[group][k].dtype == ja[group][k].dtype, (group, k)
            assert ta[group][k].tobytes() == ja[group][k].tobytes(), (group, k)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("case", ["rmat", "rmat_undirected", "padded",
                                  "bounds", "unsorted"])
def test_partition_columns_bitwise_equal_jax(case, transpose):
    g = tgen.rmat_edges(7, 8, seed=1, weights=True).dedup()
    kw = {}
    if case == "rmat_undirected":
        g = g.as_undirected()
    elif case == "padded":
        kw = {"pad_to": g.num_edges + 37}
    elif case == "bounds":
        kw = {"bucket_bounds": (4, 16)}
    elif case == "unsorted":
        kw = {"sort_by_dst": False}
    jg = jgen.Graph(g.num_vertices, g.src, g.dst, dict(g.edge_props))
    tpart = DevicePartition.from_graph(g, transpose=transpose, device="cpu",
                                       **kw)
    jpart = JaxPartition.from_graph(jg, transpose=transpose, **kw)
    _assert_same_partition(tpart, jpart)
    assert (tpart.seg_ptr is None) == (case == "unsorted")


@pytest.mark.parametrize("pad", [0, 29])
def test_row_pointer_covers_every_edge_once(pad):
    g = tgen.rmat_edges(7, 8, seed=2, weights=True).dedup()
    part = DevicePartition.from_graph(g, pad_to=g.num_edges + pad,
                                      device="cpu")
    ptr = part.seg_ptr.numpy().astype(np.int64)
    dst = part.dst.numpy()
    assert ptr.shape == (part.num_slots + 1,)
    assert ptr[0] == 0 and ptr[-1] == dst.shape[0]
    assert np.all(np.diff(ptr) >= 0)
    owner = np.repeat(np.arange(part.num_slots), np.diff(ptr))
    # every edge, real or padding, sits in exactly its own dst's range;
    # padding lands in the sink segment only
    np.testing.assert_array_equal(owner, dst)
    assert np.all(owner[~part.edge_mask.numpy()] == part.num_masters)
    assert int(part.edge_mask.sum()) == g.num_edges


def test_from_arrays_round_trips():
    g = tgen.rmat_edges(6, 8, seed=4, weights=True).dedup()
    part = DevicePartition.from_graph(g, device="cpu")
    arrays, statics = partition_arrays(part)
    again = DevicePartition.from_arrays(arrays, statics, device="cpu")
    _assert_same_partition(again, part)
    assert torch.equal(again.seg_ptr, part.seg_ptr)
    assert set(statics) == set(PARTITION_STATICS)

    rng = np.random.default_rng(0)
    st = {"vertex_data": rng.normal(size=(part.num_masters, 3))
          .astype(np.float32),
          "scatter_data": rng.normal(size=(part.num_slots, 3))
          .astype(np.float32),
          "active_scatter": rng.random(part.num_slots) < 0.5,
          "step": np.int32(7), "lane_active": np.array([True, False, True])}
    state = EngineState.from_arrays(st, device="cpu")
    back = state_arrays(state)
    assert back["step"] == 7 and isinstance(state.step, int)
    for k in ("vertex_data", "scatter_data", "active_scatter", "lane_active"):
        assert back[k].tobytes() == st[k].tobytes(), k


def test_graph_validates_props():
    with pytest.raises(AssertionError):
        Graph(3, np.array([0, 1]), np.array([1, 2]),
              {"weight": np.ones(3, np.float32)})
