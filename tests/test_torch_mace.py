"""The port's MACE (`repro_torch.models.mace`) against the JAX package's
(`repro.models.mace`) on the CPU, at the JAX smoke's size (d_hidden 8,
l_max 2, correlation 3, 2 layers), from the same parameters
(`params_from_numpy` of JAX's `init_mace`).

Tolerances: `test_torch_dimenet.py`'s, no looser: outputs and the MSE
loss rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-6.  A leaf no
output depends on (the last layer's `self` and `mix_C` for l > 0) has no
gradient in the port and a zero one in JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.models import mace as jmace
from repro.nn.equivariant import _random_rotation
from repro_torch.graph.generators import random_geometric_molecule
from repro_torch.models import gnn, mace

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(jget_config("mace")[0], d_hidden=8)


def molecule(seed, n_atoms=12, n_edges=36, mask_every=7):
    pos, src, dst = random_geometric_molecule(n_atoms, n_edges, seed=seed)
    rng = np.random.default_rng(seed)
    emask = np.ones(n_edges, bool)
    emask[::mask_every] = False
    return {"pos": pos, "species": rng.integers(0, 4, n_atoms).astype(
        np.int32), "src": src, "dst": dst, "edge_mask": emask,
        "target": rng.normal(size=(n_atoms, 1)).astype(np.float32)}


ARGS = ("pos", "species", "src", "dst", "edge_mask")


def jax_reference(params_np, mol, cfg):
    def loss(p):
        out = jmace.mace_forward(p, *(jnp.asarray(mol[k]) for k in ARGS),
                                 cfg)
        return jnp.mean((out - mol["target"]) ** 2), out
    (l, out), g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    return np.asarray(out), float(l), [np.asarray(x)
                                       for x in jax.tree.leaves(g)]


@pytest.mark.parametrize("seed", [2, 4])
def test_forward_and_grads_match_jax(cfg, seed):
    mol = molecule(seed)
    params_np = jax.tree.map(np.asarray, jmace.init_mace(
        jax.random.PRNGKey(seed), cfg, n_species=4))
    wout, wloss, wgrads = jax_reference(params_np, mol, cfg)
    params = mace.params_from_numpy(params_np, cfg, device="cpu")
    out = mace.mace_forward(params, *(torch.from_numpy(mol[k])
                                      for k in ARGS), cfg)
    loss = ((out - torch.from_numpy(mol["target"])) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), wout, **FWD)
    np.testing.assert_allclose(float(loss.detach()), wloss, **FWD)
    leaves = gnn.parameters(params)
    assert len(leaves) == len(wgrads)
    unused = 0
    for i, (p, w) in enumerate(zip(leaves, wgrads)):
        if p.grad is None:
            unused += 1
            assert not np.any(w), f"leaf {i}"
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=f"leaf {i}",
                                   **GRAD)
    # the last layer's `self` and `mix_C` for l > 0 feed only h[l > 0]
    assert unused == 2 * cfg.l_max


def test_smoke_shape_and_energy(cfg):
    pos, src, dst = random_geometric_molecule(12, 36, seed=2)
    params = mace.init_mace(torch.Generator().manual_seed(0), cfg,
                            n_species=4, device="cpu")
    args = (torch.from_numpy(pos), torch.zeros(12, dtype=torch.int32),
            torch.from_numpy(src), torch.from_numpy(dst),
            torch.ones(36, dtype=torch.bool))
    out = mace.mace_forward(params, *args, cfg)
    assert out.shape == (12, 1) and bool(torch.isfinite(out).all())
    assert torch.equal(mace.mace_energy(params, *args, cfg), out.sum())


def test_rotation_translation_invariance(cfg):
    """The JAX package's test: the energy of a rotated and shifted
    molecule, within 1e-3 relative (its bound)."""
    full = dataclasses.replace(cfg, d_hidden=16)
    pos, src, dst = random_geometric_molecule(20, 60, seed=0)
    params = mace.init_mace(torch.Generator().manual_seed(0), full,
                            n_species=8, device="cpu")
    species = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5, 20).astype(np.int32))
    args = (species, torch.from_numpy(src), torch.from_numpy(dst),
            torch.ones(60, dtype=torch.bool), full)
    R = torch.from_numpy(_random_rotation(np.random.default_rng(3))).float()
    p = torch.from_numpy(pos)
    e1 = float(mace.mace_energy(params, p, *args).detach())
    e2 = float(mace.mace_energy(params, p @ R.T + 2.5, *args).detach())
    assert abs(e1 - e2) < 1e-3 * (abs(e1) + 1)


def test_custom_prop_fn(cfg):
    """`prop_fn` replaces the aggregation: the plain scatter sum gives the
    default's outputs."""
    mol = molecule(2)
    params = mace.init_mace(torch.Generator().manual_seed(1), cfg,
                            n_species=4, device="cpu")
    args = [torch.from_numpy(mol[k]) for k in ARGS]
    V = args[0].shape[0]

    def plain(msgs, dst):
        out = torch.zeros((V,) + tuple(msgs.shape[1:]))
        return out.index_add(0, dst.long(), msgs)

    a = mace.mace_forward(params, *args, cfg)
    b = mace.mace_forward(params, *args, cfg, prop_fn=plain)
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               **FWD)
