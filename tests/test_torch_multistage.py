"""The port's multi-stage Brandes BC (`repro_torch.core.multistage`)
against the JAX package's `betweenness_centrality` on the same graphs, and
each stage's superstep against the JAX package's on the same state.

Tolerances: depths and σ are exact f32 sums of small integers, so one
forward superstep matches bitwise.  δ and BC sum floats in another order
than XLA's segment sum, so they are held at rtol = atol = 1e-4, the JAX
package's own tolerance against networkx (`tests/test_multistage.py`).
"""
import dataclasses

import networkx as nx
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import multistage as jms
from repro.core.engine import DevicePartition as JaxPartition
from repro.core.engine import EngineState as JaxState
from repro.core.engine import GREEngine as JaxEngine
from repro.graph import generators as jgen
from repro.graph.structures import Graph as JaxGraph
from repro_torch.core import multistage as ms
from repro_torch.core.engine import DevicePartition, GREEngine
from repro_torch.graph.generators import (erdos_renyi_edges, grid_graph,
                                          rmat_edges)

from torch_parity import state_arrays, to_graph

TOL = 1e-4
GRAPHS = {
    "grid": lambda: grid_graph(4, 5),
    "random": lambda: erdos_renyi_edges(40, 160, seed=1).dedup(),
    "scale_free": lambda: rmat_edges(scale=6, edge_factor=4, seed=2).dedup(),
}


def _jax(g):
    return to_graph(g, JaxGraph)


def test_grid_graph_is_byte_identical():
    g, jg = grid_graph(4, 5), jgen.grid_graph(4, 5)
    assert g.num_vertices == jg.num_vertices
    for a, b in ((g.src, jg.src), (g.dst, jg.dst)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bc_matches_jax(name):
    g = GRAPHS[name]()
    got = ms.betweenness_centrality(g, device="cpu")
    want = jms.betweenness_centrality(_jax(g))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bc_grid_matches_networkx():
    g = grid_graph(4, 5)
    nxg = nx.DiGraph()
    nxg.add_nodes_from(range(g.num_vertices))
    nxg.add_edges_from(zip(g.src.tolist(), g.dst.tolist()))
    want = nx.betweenness_centrality(nxg, normalized=False)
    ref = np.array([want[i] for i in range(g.num_vertices)])
    np.testing.assert_allclose(ms.betweenness_centrality(g, device="cpu"),
                               ref, rtol=TOL, atol=TOL)


def test_bc_sampled_matches_jax():
    """Sampled sources with a ragged last batch: the tail is padded by
    repeating its last source and weighted out, as in the JAX package."""
    g = rmat_edges(scale=8, edge_factor=8, seed=0).dedup()
    sources = range(0, g.num_vertices, 8)
    got = ms.betweenness_centrality(g, sources=sources, batch=12,
                                    device="cpu")
    want = jms.betweenness_centrality(_jax(g), sources=sources, batch=12)
    assert np.isfinite(got).all() and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _forward_states(g, sources):
    """The seeded forward states of both packages (as `_make_bc_batch`
    seeds them), on their own partitions of the same graph."""
    D = len(sources)
    part = DevicePartition.from_graph(g, device="cpu")
    jpart = JaxPartition.from_graph(_jax(g))
    eng = GREEngine(ms.bc_forward_program(D))
    jeng = JaxEngine(jms.bc_forward_program(D))
    src = torch.tensor(sources)
    lanes = torch.arange(D)
    st = eng.init_state(part)
    st.vertex_data[src, lanes] = torch.tensor([0.0, 1.0])
    st.scatter_data[src, lanes] = torch.tensor([1.0, 1.0, 1.0])
    st.active_scatter[src] = True
    jst = jeng.init_state(jpart)
    jsrc, jl = jnp.asarray(sources), jnp.arange(D)
    jst = JaxState(jst.vertex_data.at[jsrc, jl].set(jnp.array([0.0, 1.0])),
                   jst.scatter_data.at[jsrc, jl].set(jnp.ones(3)),
                   jst.active_scatter.at[jsrc].set(True), jst.step)
    return (eng, part, st), (jeng, jpart, jst)


def test_forward_superstep_matches_jax():
    g = GRAPHS["scale_free"]()
    (eng, part, st), (jeng, jpart, jst) = _forward_states(g, [0, 5, 9, 5])
    for _ in range(3):
        st, jst = eng.superstep(part, st), jeng.superstep(jpart, jst)
        got, want = state_arrays(st), state_arrays(jst)
        for k in ("vertex_data", "scatter_data", "active_scatter"):
            assert np.array_equal(got[k], want[k]), k
        assert got["step"] == want["step"]


def test_backward_superstep_matches_jax():
    """One backward superstep on the transposed partitions from the same
    forward fixed point (the JAX package's): depths line up bitwise and
    the δ fold and its scatter within 1e-4."""
    g = GRAPHS["scale_free"]()
    sources = [0, 5, 9, 33]
    D = len(sources)
    _, (jeng, jpart, jst) = _forward_states(g, sources)
    out = jeng.run(jpart, jst, 64)
    depth = np.array(out.vertex_data[..., 0])
    sigma = np.array(out.vertex_data[..., 1])
    dmax = np.float32(np.max(np.where(np.isinf(depth), -1.0, depth)))
    assert dmax >= 2
    part = DevicePartition.from_graph(g, transpose=True, device="cpu")
    jpart_b = JaxPartition.from_graph(_jax(g), transpose=True)
    part = dataclasses.replace(part, aux={
        **part.aux, "depth": torch.from_numpy(depth),
        "sigma": torch.from_numpy(sigma), "dmax": torch.tensor(dmax)})
    jpart_b = dataclasses.replace(jpart_b, aux={
        **jpart_b.aux, "depth": jnp.asarray(depth),
        "sigma": jnp.asarray(sigma), "dmax": jnp.asarray(dmax)})
    eng = GREEngine(ms.bc_backward_program(D), dense_frontier=False)
    jeng_b = JaxEngine(jms.bc_backward_program(D), dense_frontier=False)
    st, jst_b = eng.init_state(part), jeng_b.init_state(jpart_b)
    assert np.array_equal(state_arrays(st)["scatter_data"],
                          state_arrays(jst_b)["scatter_data"])
    for _ in range(2):
        st, jst_b = eng.superstep(part, st), jeng_b.superstep(jpart_b, jst_b)
        got, want = state_arrays(st), state_arrays(jst_b)
        assert np.array_equal(got["active_scatter"], want["active_scatter"])
        for k in ("vertex_data", "scatter_data"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    assert np.asarray(st.vertex_data).any()       # some level folded


def test_bc_batch_exposes_forward_outputs():
    """`_make_bc_batch`'s pipeline keeps the last batch's depths, σ and
    superstep counts; a source's own δ lane is zero at its vertex."""
    g = GRAPHS["grid"]()
    run = ms._make_bc_batch(g, 64, 2, device="cpu")
    delta = run(np.array([0, 19]))
    assert delta.shape == (20, 2)
    assert float(delta[0, 0]) == 0.0 and float(delta[19, 1]) == 0.0
    assert run.depth[0, 0] == 0 and run.depth[19, 0] == 7   # grid corners
    assert run.sigma[19, 0] == 35                            # C(7, 3) paths
    fwd, bwd = run.supersteps
    assert fwd == 8 and bwd == 8
