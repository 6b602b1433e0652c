"""The port's GNN models (`repro_torch.models.gnn`) against the JAX
package's (`repro.models.gnn`) on the CPU: the same numpy inputs and the
same parameters (`params_from_numpy` of JAX's `init_gnn`) through both.

Tolerances: forward values (logits, loss, layer outputs) rtol 1e-5 /
atol 1e-6; gradients rtol 1e-4 / atol 1e-6.  The port sums each segment
in the batch's edge order, as XLA's CPU scatter does, so most values agree
far more closely; matmuls and the sums of the gradients differ in order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.graph.generators import rmat_edges as jrmat
from repro.models import gnn as jgnn
from repro_torch.configs import get_config
from repro_torch.core import algorithms
from repro_torch.core.agent_graph import build_agent_graph
from repro_torch.core.dist_engine import DistGREEngine
from repro_torch.dist.comm import StackedComm
from repro_torch.graph.structures import Graph
from repro_torch.models import gnn

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
D_IN = 12


@pytest.fixture(scope="module")
def graph():
    """An R-MAT graph with every seventh edge masked, features, labels
    (below 2, so valid for both configs) and a train mask."""
    g = jrmat(scale=7, edge_factor=6, seed=0).dedup()
    rng = np.random.default_rng(0)
    v, e = g.num_vertices, g.num_edges
    mask = np.ones(e, bool)
    mask[::7] = False
    return {"V": v, "src": g.src.astype(np.int32),
            "dst": g.dst.astype(np.int32), "mask": mask,
            "feats": rng.normal(size=(v, D_IN)).astype(np.float32) * 0.5,
            "labels": rng.integers(0, 2, v), "train": rng.random(v) < 0.5}


def jax_batch(gr, norm=True):
    src, dst, mask = (jnp.asarray(gr[k]) for k in ("src", "dst", "mask"))
    return jgnn.GraphBatch(
        jnp.asarray(gr["feats"]), src, dst, mask, jnp.asarray(gr["labels"]),
        jnp.asarray(gr["train"]),
        edge_norm=(jgnn.compute_gcn_edge_norm(src, dst, mask, gr["V"])
                   if norm else None))


def port_batch(gr, norm=True):
    t = {k: torch.from_numpy(gr[k]) for k in ("src", "dst", "mask")}
    return gnn.GraphBatch.build(
        gr["feats"], gr["src"], gr["dst"], gr["mask"], gr["labels"],
        gr["train"],
        edge_norm=(gnn.compute_gcn_edge_norm(t["src"], t["dst"], t["mask"],
                                             gr["V"]) if norm else None),
        device="cpu")


def jax_params(arch, d_in=D_IN, seed=1):
    cfg = jget_config(arch)[0]
    p = jgnn.init_gnn(jax.random.PRNGKey(seed), cfg, d_in, cfg.n_classes)
    if cfg.eps_learnable:        # eps away from 0, so (1 + eps)·h is held
        for i, lp in enumerate(p["layers"]):
            lp["eps"] = jnp.asarray(0.1 * (i + 1), jnp.float32)
    return cfg, p


def assert_grads(got_params, jgrads, tol=GRAD):
    want = jax.tree.leaves(jgrads)
    got = gnn.parameters(got_params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.grad is not None and g.grad.shape == w.shape
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("arch", ["gcn-cora", "gin-tu"])
def test_forward_loss_and_grads_match_jax(graph, arch):
    jcfg, jp = jax_params(arch)
    cfg = get_config(arch)[0]
    jb = jax_batch(graph)
    p = gnn.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu")
    b = port_batch(graph)
    np.testing.assert_array_equal(
        b.edge_norm.numpy(), np.asarray(jb.edge_norm))
    logits = gnn.gnn_forward(p, b, cfg)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jgnn.gnn_forward(jp, jb, jcfg)),
                               **FWD)
    jl, jg = jax.value_and_grad(jgnn.gnn_loss)(jp, jb, jcfg)
    loss = gnn.gnn_loss(p, b, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    assert_grads(p, jg)


def test_graph_classification_pooling_matches_jax():
    """GIN over a batch of small graphs, mean-pooled per graph through the
    combine (graph ids sorted), against JAX's segment-sum pooling."""
    rng = np.random.default_rng(4)
    n_graphs, nodes, edges = 6, 9, 20
    src = np.concatenate([rng.integers(0, nodes, edges) + i * nodes
                          for i in range(n_graphs)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, nodes, edges) + i * nodes
                          for i in range(n_graphs)]).astype(np.int32)
    mask = rng.random(src.shape[0]) < 0.9
    v = n_graphs * nodes
    feats = rng.normal(size=(v, 16)).astype(np.float32)
    gids = np.repeat(np.arange(n_graphs), nodes).astype(np.int32)
    gids[-nodes:] = n_graphs - 2     # an empty last graph
    labels = rng.integers(0, 2, n_graphs)
    jcfg, jp = jax_params("gin-tu", d_in=16)
    cfg = get_config("gin-tu")[0]
    jb = jgnn.GraphBatch(jnp.asarray(feats), jnp.asarray(src),
                         jnp.asarray(dst), jnp.asarray(mask),
                         jnp.asarray(labels), jnp.ones(v, bool),
                         graph_ids=jnp.asarray(gids), num_graphs=n_graphs)
    b = gnn.GraphBatch.build(feats, src, dst, mask, labels, np.ones(v, bool),
                             graph_ids=gids, num_graphs=n_graphs,
                             device="cpu")
    p = gnn.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu")
    np.testing.assert_allclose(gnn.gnn_forward(p, b, cfg).detach().numpy(),
                               np.asarray(jgnn.gnn_forward(jp, jb, jcfg)),
                               **FWD)
    jl, jg = jax.value_and_grad(jgnn.gnn_loss)(jp, jb, jcfg)
    loss = gnn.gnn_loss(p, b, cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    assert_grads(p, jg)
    with pytest.raises(ValueError, match="sorted"):
        gnn.GraphBatch.build(feats, src, dst, mask, labels, np.ones(v, bool),
                             graph_ids=gids[::-1].copy(),
                             num_graphs=n_graphs, device="cpu")


def _layer_case(graph, seed):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(graph["V"], 16)).astype(np.float32)
    j = {k: jnp.asarray(graph[k]) for k in ("src", "dst", "mask")}
    t = {k: torch.from_numpy(graph[k]) for k in ("src", "dst", "mask")}
    return h, j, t


def _params_like(jparams):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in jparams.items()}


def test_gat_forward_and_grads_match_jax(graph):
    h, j, t = _layer_case(graph, 5)
    jp = jgnn.gat_layer_init(jax.random.PRNGKey(2), 16, 8, n_heads=2)
    p = _params_like(jp)
    hh = torch.from_numpy(h).requires_grad_(True)

    def jloss(params, x):
        out = jgnn.gat_layer(params, x, j["src"], j["dst"], j["mask"],
                             graph["V"], n_heads=2)
        return (out ** 2).mean(), out

    (jl, jout), (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True)(
        jp, jnp.asarray(h))
    out = gnn.gat_layer(p, hh, t["src"], t["dst"], t["mask"], graph["V"],
                        n_heads=2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    (out ** 2).mean().backward()
    for k in jp:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgp[k]),
                                   **GRAD)
    np.testing.assert_allclose(hh.grad.numpy(), np.asarray(jgh), **GRAD)


@pytest.mark.parametrize("agg", ["mean", "max"])
def test_sage_forward_and_grads_match_jax(graph, agg):
    h, j, t = _layer_case(graph, 6)
    jp = jgnn.sage_layer_init(jax.random.PRNGKey(3), 16, 8)
    p = _params_like(jp)
    hh = torch.from_numpy(h).requires_grad_(True)

    def jloss(params, x):
        out = jgnn.sage_layer(params, x, j["src"], j["dst"], j["mask"],
                              graph["V"], agg)
        return out.sum(), out

    (_, jout), (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jp, jnp.asarray(h))
    out = gnn.sage_layer(p, hh, t["src"], t["dst"], t["mask"], graph["V"],
                         agg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    out.sum().backward()
    for k in jp:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgp[k]),
                                   **GRAD)
    np.testing.assert_allclose(hh.grad.numpy(), np.asarray(jgh), **GRAD)


@pytest.mark.parametrize("weighted", [False, True])
def test_engine_propagate_equals_propagate(graph, weighted):
    """One superstep of `gnn_aggregate_program` on the engine gives
    `propagate`'s sums bitwise (the same edges in the same order), and
    both agree with JAX's `propagate`."""
    b = port_batch(graph)
    h = torch.from_numpy(np.random.default_rng(7).normal(
        size=(graph["V"], 8)).astype(np.float32))
    ew = b.edge_norm if weighted else None
    want = gnn.propagate(h, b.src, b.dst, b.edge_mask, graph["V"], ew,
                         routes=b.routes)
    got = gnn.engine_propagate(b)(h, ew)
    assert torch.equal(got, want)
    jb = jax_batch(graph)
    jw = jb.edge_norm if weighted else None
    ref = jgnn.propagate(jnp.asarray(h.numpy()), jb.src, jb.dst,
                         jb.edge_mask, graph["V"], jw)
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), **FWD)
    # the routes built on the fly give the same sums
    assert torch.equal(gnn.propagate(h, b.src, b.dst, b.edge_mask,
                                     graph["V"], ew), want)


@pytest.mark.parametrize("weighted", [False, True])
def test_propagate_gradcheck(graph, weighted):
    """`propagate`'s backward (the transpose: gather at dst in src order,
    combine over the src row pointer) against finite differences in
    float64, masked edges included in the batch."""
    b = port_batch(graph)
    h = torch.from_numpy(np.random.default_rng(9).normal(
        size=(graph["V"], 3))).requires_grad_(True)
    ew = b.edge_norm.double() if weighted else None
    assert torch.autograd.gradcheck(
        lambda x: gnn.propagate(x, b.src, b.dst, b.edge_mask, graph["V"],
                                ew, routes=b.routes), (h,))


def test_propagate_refuses_a_weight_that_needs_a_gradient(graph):
    b = port_batch(graph)
    h = torch.ones((graph["V"], 2))
    with pytest.raises(ValueError, match="edge weights are data"):
        gnn.propagate(h, b.src, b.dst, b.edge_mask, graph["V"],
                      b.edge_norm.clone().requires_grad_(True),
                      routes=b.routes)


@pytest.fixture(scope="module")
def sharded(graph):
    """The graph's live edges on k = 4 HDRF shards, stacked on the CPU."""
    m = graph["mask"]
    g = Graph(graph["V"], graph["src"][m], graph["dst"][m])
    ag = build_agent_graph(g, "hdrf", 4)
    topo = DistGREEngine(algorithms.bfs_program(), 4, exchange="agent",
                         device="cpu").device_topology(ag)
    return ag, topo


@pytest.mark.parametrize("arch", ["gcn-cora", "gin-tu"])
def test_propagate_sharded_k4_matches_whole_graph(graph, sharded, arch):
    """GCN and GIN through `propagate_sharded` over k = 4 stacked shards
    against JAX's `propagate` over the whole graph: the loss, every
    parameter gradient, and one propagation and its input gradient."""
    ag, topo = sharded
    jcfg, jp = jax_params(arch)
    cfg = get_config(arch)[0]
    jb = jax_batch(graph)
    b = port_batch(graph)
    stacked, prop_fn = gnn.shard_graph_batch(b, ag, topo, StackedComm(4))
    p = gnn.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                              device="cpu")
    jl, jg = jax.value_and_grad(jgnn.gnn_loss)(jp, jb, jcfg)
    loss = gnn.gnn_loss(p, stacked, cfg, prop_fn=prop_fn)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **FWD)
    assert_grads(p, jg)
    # one propagation: master rows against the whole-graph sums
    rng = np.random.default_rng(8)
    h = rng.normal(size=(graph["V"], 5)).astype(np.float32)
    cot = rng.normal(size=(graph["V"], 5)).astype(np.float32)

    def jprop(x):
        out = jgnn.propagate(x, jb.src, jb.dst, jb.edge_mask, graph["V"],
                             jb.edge_norm)
        return (out * jnp.asarray(cot)).sum(), out

    (_, jout), jgh = jax.value_and_grad(jprop, has_aux=True)(jnp.asarray(h))
    slots = torch.from_numpy(
        (ag.old2new // ag.cap) * ag.num_slots + ag.old2new % ag.cap)
    hs = torch.zeros((ag.k * ag.num_slots, 5)).index_copy(
        0, slots, torch.from_numpy(h)).requires_grad_(True)
    out = prop_fn(hs, stacked.edge_norm)
    np.testing.assert_allclose(out[slots].detach().numpy(), np.asarray(jout),
                               **FWD)
    cs = torch.zeros_like(out).index_copy(0, slots, torch.from_numpy(cot))
    (out * cs).sum().backward()
    np.testing.assert_allclose(hs.grad[slots].numpy(), np.asarray(jgh),
                               **GRAD)


def test_init_gnn_shapes_and_leaves():
    """`init_gnn` draws the JAX package's tree of shapes, every leaf a
    float32 tensor that requires a gradient; `parameters` walks it in JAX's
    leaf order."""
    for arch in ("gcn-cora", "gin-tu"):
        cfg = get_config(arch)[0]
        p = gnn.init_gnn(torch.Generator().manual_seed(0), cfg, 10,
                         cfg.n_classes, device="cpu")
        jp = jax.eval_shape(lambda k: jgnn.init_gnn(
            k, jget_config(arch)[0], 10, cfg.n_classes),
            jax.ShapeDtypeStruct((2,), jnp.uint32))
        leaves = gnn.parameters(p)
        assert [tuple(x.shape) for x in leaves] == \
            [tuple(x.shape) for x in jax.tree.leaves(jp)]
        assert all(x.requires_grad and x.dtype == torch.float32
                   for x in leaves)
