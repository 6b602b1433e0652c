"""The port's DimeNet (`repro_torch.models.dimenet`) against the JAX
package's (`repro.models.dimenet`) on the CPU, at the JAX smoke's reduced
config (2 blocks, d_hidden 16, n_bilinear 4), from the same parameters
(`params_from_numpy` of JAX's `init_dimenet`, biases moved off zero so
that masked edges carry values).

Tolerances (`test_torch_gnn.py`'s): outputs and the MSE loss rtol 1e-5 /
atol 1e-6, gradients (`jax.value_and_grad`) rtol 1e-4 / atol 1e-6.  The
port sums each segment in index order through the combine kernel's plain
version; XLA's CPU scatter and the matmuls round in another order.

`dimenet_forward_sharded` is held against JAX's whole-graph forward at
the same bounds, over `StackedComm(k)` and over 4 gloo ranks on the CPU
(`torch_dist_cases.dimenet_sharded_case`); the ranks also against the
stacked pass, loss and gradients within 1e-6 of each leaf's largest.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.graph.generators import random_geometric_molecule as jmolecule
from repro.models import dimenet as jdn
from repro.nn.equivariant import _random_rotation
from repro_torch.dist.comm import StackedComm
from repro_torch.dist.world import run_world
from repro_torch.graph.generators import random_geometric_molecule
from repro_torch.models import dimenet, gnn

import torch_dist_cases as cases
from torch_parity import JAX_K

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
RANK_TOL = 1e-6
WORLD_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def cfg():
    c = jget_config("dimenet")[0]
    return dataclasses.replace(c, n_layers=2, d_hidden=16, n_bilinear=4)


@pytest.fixture(scope="module")
def params_np(cfg):
    p = jax.tree.map(np.asarray, jdn.init_dimenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32), p)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def jax_reference(params_np, mol, cfg):
    """JAX's outputs, MSE loss and gradients over the whole graph."""
    def loss(p):
        out = jdn.dimenet_forward(
            p, *(jnp.asarray(mol[k]) for k in (
                "pos", "species", "src", "dst", "edge_mask", "tri_kj",
                "tri_ji", "tri_mask")), cfg)
        return jnp.mean((out - mol["target"]) ** 2), out
    (l, out), g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    return np.asarray(out), float(l), [np.asarray(x)
                                       for x in jax.tree.leaves(g)]


def port_pass(params_np, mol, cfg):
    params = dimenet.params_from_numpy(params_np, cfg, device="cpu")
    out = dimenet.dimenet_forward(params, *(_t(mol[k]) for k in (
        "pos", "species", "src", "dst", "edge_mask", "tri_kj", "tri_ji",
        "tri_mask")), cfg)
    loss = ((out - _t(mol["target"])) ** 2).mean()
    loss.backward()
    return out.detach().numpy(), float(loss.detach()), [p.grad.numpy() for p in
                                                gnn.parameters(params)]


def assert_close(got, want):
    out, loss, grads = got
    wout, wloss, wgrads = want
    np.testing.assert_allclose(out, wout, **FWD)
    np.testing.assert_allclose(loss, wloss, **FWD)
    assert len(grads) == len(wgrads)
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        np.testing.assert_allclose(g, w, err_msg=f"leaf {i}", **GRAD)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_random_geometric_molecule_bitwise(seed):
    got, want = random_geometric_molecule(30, 64, seed), jmolecule(30, 64,
                                                                   seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("pad", [0, 400])
def test_build_triplets_equal(pad):
    _, src, dst = random_geometric_molecule(16, 48, seed=1)
    got = dimenet.build_triplets(src, dst, 16, pad_to=pad)
    want = jdn.build_triplets(src, dst, 16, pad_to=pad)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2].sum() < got[2].shape[0] or pad == 0


@pytest.mark.parametrize("shuffle", [False, True])
def test_forward_and_grads_match_jax(cfg, params_np, shuffle):
    """Outputs, loss and gradients; `shuffle` puts the live triplets in a
    random order (an unsorted `tri_ji`), padding at the end either way."""
    mol = cases.molecule_inputs(shuffle=shuffle)
    if shuffle:
        assert np.any(np.diff(mol["tri_ji"][mol["tri_mask"]]) < 0)
    assert not mol["tri_mask"][-1] and not mol["edge_mask"].all()
    assert_close(port_pass(params_np, mol, cfg),
                 jax_reference(params_np, mol, cfg))


def test_smoke_shape(cfg):
    """The JAX smoke's molecule: 16 atoms, 48 edges, species 0."""
    pos, src, dst = random_geometric_molecule(16, 48, seed=1)
    kj, ji, tm = dimenet.build_triplets(src, dst, 16)
    params = dimenet.init_dimenet(torch.Generator().manual_seed(0), cfg,
                                  device="cpu")
    out = dimenet.dimenet_forward(
        params, _t(pos), torch.zeros(16, dtype=torch.int32), _t(src),
        _t(dst), torch.ones(48, dtype=torch.bool), _t(kj), _t(ji), _t(tm),
        cfg)
    assert out.shape == (16, 1) and bool(torch.isfinite(out).all())


def test_rotation_translation_invariance(params_np, cfg):
    mol = cases.molecule_inputs()
    params = dimenet.params_from_numpy(params_np, cfg, device="cpu")
    rest = [_t(mol[k]) for k in ("species", "src", "dst", "edge_mask",
                                 "tri_kj", "tri_ji", "tri_mask")]
    R = torch.from_numpy(_random_rotation(np.random.default_rng(3))).float()
    pos = _t(mol["pos"])
    a = dimenet.dimenet_forward(params, pos, *rest, cfg)
    b = dimenet.dimenet_forward(params, pos @ R.T - 1.0, *rest, cfg)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_stacked_matches_jax(cfg, params_np, k):
    mol = cases.molecule_inputs()
    got = cases.dimenet_sharded_case(mol, cfg, params_np, StackedComm(k))
    grads = [got[f"grad{i}"] for i in range(len(
        [f for f in got if f.startswith("grad")]))]
    assert_close((got["out"], float(got["loss"]), grads),
                 jax_reference(params_np, mol, cfg))


def test_sharded_layout_places_triplets_locally(cfg):
    """Every live triplet sits on its kj edge's shard (a local master) and
    some flush carries values: the placement is the Agent-Graph one, not a
    replica."""
    mol = cases.molecule_inputs()
    sh = dimenet.shard_molecule_graph(
        *(mol[k] for k in ("pos", "species", "src", "dst", "edge_mask",
                           "tri_kj", "tri_ji", "tri_mask")),
        cfg, StackedComm(4), device="cpu")
    assert int(sh.tri_mask.sum()) == int(mol["tri_mask"].sum())
    assert sh.ag_tri.num_combiner.sum() > 0 and \
        sh.ag_node.num_combiner.sum() > 0
    ag = sh.ag_node
    for i in range(4):
        eids = ag.edge_props["eid"][i, :ag.num_edges[i]]
        assert np.all(sh.ag_tri.old2new[eids] // sh.ag_tri.cap == i)


@pytest.fixture(scope="module")
def world(tmp_path_factory, cfg, params_np):
    mol = cases.molecule_inputs()
    out = tmp_path_factory.mktemp("dimenet_ranks")
    done = run_world(cases.dimenet_rank_main, JAX_K,
                     (mol, cfg, params_np, str(out)), device="cpu",
                     timeout=WORLD_TIMEOUT)
    assert [r.value for r in done] == list(range(JAX_K))
    ranks = []
    for r in range(JAX_K):
        with np.load(out / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    stacked = cases.dimenet_sharded_case(mol, cfg, params_np,
                                         StackedComm(JAX_K))
    return mol, ranks, stacked


def test_sharded_ranks_match_jax(world, cfg, params_np):
    mol, ranks, _ = world
    want = jax_reference(params_np, mol, cfg)
    for got in ranks:
        n = len([f for f in got if f.startswith("grad")])
        assert_close((got["out"], float(got["loss"]),
                      [got[f"grad{i}"] for i in range(n)]), want)


def test_sharded_ranks_match_stacked(world):
    _, ranks, stacked = world
    for r, got in enumerate(ranks):
        assert sorted(got) == sorted(stacked)
        np.testing.assert_allclose(got["loss"], stacked["loss"],
                                   rtol=RANK_TOL, atol=0)
        np.testing.assert_allclose(got["out"], stacked["out"],
                                   rtol=RANK_TOL, atol=1e-7)
        for f in stacked:
            if f.startswith("grad"):
                scale = np.abs(stacked[f]).max()
                np.testing.assert_allclose(got[f], stacked[f], rtol=0,
                                           atol=RANK_TOL * scale,
                                           err_msg=f"rank {r} {f}")
