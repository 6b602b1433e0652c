"""The port's distributed engine on a `torch.distributed` world: one
Agent-Graph shard a process (`ProcessGroupComm`), 4 gloo ranks on the CPU
at 127.0.0.1, against the JAX package's `DistGREEngine` at k = 4 and the
port's own k = 4 shards stacked in one process (`StackedComm`).

One world a module (`repro_torch.dist.world.run_world`) runs every case
(`torch_dist_cases.all_cases`) and each rank writes its results to
`tmp_path`; the stacked counterparts run in this process.  Each case is
its own test:

- every `JAX_CASES` case (the JAX k = 4 subprocess's `.npz`, shared with
  test_torch_dist_engine.py): min programs bitwise against JAX and the
  stacked port on every rank, PageRank within rtol 1e-5 / atol 1e-6 of
  JAX's (its own backends differ in the last bit, ROADMAP Queue 3) and
  bitwise against the stacked port; superstep counts equal; the ranks'
  `values` add up to the stacked count;
- serving ticks (`make_superstep`, 4-lane BFS): every tick's result and
  every rank's `lane_active`, the global verdict, equal the stacked ones;
- `rerun_incremental` under a 1% churn, SSSP and BFS: bitwise the stacked
  rerun's;
- GCN and GIN: the k-shard loss and every gradient within 1e-6
  (relative) of the stacked pass's, and against `jax.value_and_grad` of
  JAX's `gnn_loss` over the whole graph at test_torch_gnn.py's tolerances
  (loss rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import gnn as jgnn
from repro_torch.dist.world import run_world

import torch_dist_cases as cases
from torch_parity import JAX_CASES, JAX_K, jax_dist_results

WORLD_TIMEOUT = 240.0          # seconds; a hung rank fails inside it
PR_RTOL, PR_ATOL = 1e-5, 1e-6
GNN_RTOL = 1e-6
FWD = dict(rtol=1e-5, atol=1e-6)            # test_torch_gnn.py's
GRAD = dict(rtol=1e-4, atol=1e-6)


def _params(arch):
    """JAX's `init_gnn` parameters as numpy (GIN's eps moved off 0, as in
    test_torch_gnn.py)."""
    cfg = jget_config(arch)[0]
    p = jgnn.init_gnn(jax.random.PRNGKey(1), cfg, 12, cfg.n_classes)
    if cfg.eps_learnable:
        for i, lp in enumerate(p["layers"]):
            lp["eps"] = np.float32(0.1 * (i + 1))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def inputs():
    """`(ags, delta, gnn_in, params)`: every case's inputs."""
    return cases.inputs() + ({a: _params(a) for a in cases.GNN_ARCHS},)


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    """`(ranks, stacked)`: each rank's results and the stacked ones."""
    ags, delta, gnn_in, params = inputs
    out = tmp_path_factory.mktemp("ranks")
    done = run_world(cases.rank_main, JAX_K,
                     (ags, delta, gnn_in, params, JAX_CASES, str(out)),
                     device="cpu", timeout=WORLD_TIMEOUT)
    assert [r.value for r in done] == list(range(JAX_K))
    ranks = []
    for r in range(JAX_K):
        with np.load(out / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    return ranks, cases.stacked_cases(ags, delta, gnn_in, params, JAX_CASES)


@pytest.fixture(scope="module")
def jax_dist(tmp_path_factory):
    return jax_dist_results(tmp_path_factory)


@pytest.mark.parametrize("name,backend", JAX_CASES)
def test_ranks_match_jax_and_stacked(world, jax_dist, name, backend):
    ranks, stacked = world
    key = f"{name}/{backend}"
    want_jax = jax_dist[f"{key}/vd"]
    for r, got in enumerate(ranks):
        vd = got[f"{key}/vd"]
        if name == "pagerank":
            np.testing.assert_allclose(vd, want_jax, rtol=PR_RTOL,
                                       atol=PR_ATOL)
        else:
            assert vd.dtype == want_jax.dtype
            np.testing.assert_array_equal(vd, want_jax, err_msg=f"rank {r}")
        np.testing.assert_array_equal(vd, stacked[f"{key}/vd"],
                                      err_msg=f"rank {r}")
        assert got[f"{key}/step"] == stacked[f"{key}/step"]
        assert np.all(jax_dist[f"{key}/step"] == got[f"{key}/step"])
    assert sum(int(got[f"{key}/values"]) for got in ranks) == \
        int(stacked[f"{key}/values"])


@pytest.mark.parametrize("exchange", cases.TICK_EXCHANGES)
def test_serving_ticks_match_stacked(world, exchange):
    """Every tick's result, and each rank's lane halt row: the OR over all
    shards (`comm.pmax`), not over the rank's own shard."""
    ranks, stacked = world
    key = f"tick/{exchange}"
    lanes = stacked[f"{key}/lane_active"]              # [ticks, k, D]
    assert lanes.any() and not lanes[-1].all()         # lanes do halt
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"{key}/vd"], stacked[f"{key}/vd"])
        np.testing.assert_array_equal(got[f"{key}/lane_active"][:, 0],
                                      lanes[:, r], err_msg=f"rank {r}")


@pytest.mark.parametrize("name", cases.INCREMENTAL)
def test_rerun_incremental_matches_stacked(world, name):
    ranks, stacked = world
    key = f"incremental/{name}"
    for got in ranks:
        np.testing.assert_array_equal(got[f"{key}/vd"], stacked[f"{key}/vd"])
        assert got[f"{key}/step"] == stacked[f"{key}/step"]


@pytest.mark.parametrize("arch", cases.GNN_ARCHS)
def test_gnn_over_ranks_matches_stacked(world, arch):
    ranks, stacked = world
    key = f"gnn/{arch}"
    grads = sorted(f for f in stacked if f.startswith(f"{key}/grad"))
    assert grads
    for got in ranks:
        np.testing.assert_allclose(got[f"{key}/loss"], stacked[f"{key}/loss"],
                                   rtol=GNN_RTOL, atol=0)
        for f in grads:
            want = stacked[f]
            scale = np.abs(want).max()
            np.testing.assert_allclose(got[f], want, rtol=0,
                                       atol=GNN_RTOL * scale, err_msg=f)


@pytest.mark.parametrize("arch", cases.GNN_ARCHS)
def test_gnn_over_ranks_matches_jax(world, inputs, arch):
    """The ranks' k-shard loss and gradients against JAX's whole-graph
    `gnn_loss` and its `jax.value_and_grad` on the same graph, features,
    mask and parameters: a fault that the rank and stacked passes share
    (the node rows' sharding, the global count of training nodes) shows
    here."""
    ranks, _ = world
    _, _, g, params = inputs
    jcfg = jget_config(arch)[0]
    src, dst, mask = (jnp.asarray(g[f]) for f in ("src", "dst", "mask"))
    v = g["feats"].shape[0]
    jb = jgnn.GraphBatch(
        jnp.asarray(g["feats"]), src, dst, mask, jnp.asarray(g["labels"]),
        jnp.asarray(g["train"]),
        edge_norm=(jgnn.compute_gcn_edge_norm(src, dst, mask, v)
                   if jcfg.family == "gcn" else None))
    jl, jg = jax.value_and_grad(jgnn.gnn_loss)(
        jax.tree.map(jnp.asarray, params[arch]), jb, jcfg)
    want = jax.tree.leaves(jg)
    key = f"gnn/{arch}"
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"{key}/loss"], float(jl), **FWD)
        assert len([f for f in got if f.startswith(f"{key}/grad")]) == \
            len(want)
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"{key}/grad{i}"], np.asarray(w),
                                       err_msg=f"rank {r} leaf {i}", **GRAD)
