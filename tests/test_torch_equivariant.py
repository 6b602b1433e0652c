"""The port's E(3) building blocks (`repro_torch.nn.equivariant`) against
the JAX package's (`repro.nn.equivariant`) on the same numpy inputs.

The host-side construction is a numpy copy: `real_sh_np`,
`_random_rotation`, `wigner_d`, `cg_tensor` and `valid_paths` are held
bitwise for l ≤ 2.  The tensor functions (`real_sh`, `bessel_basis`,
`cosine_cutoff`) are held within rtol 1e-6 / atol 1e-6 (float32
transcendentals of two libraries)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.nn import equivariant as jeq
from repro_torch.nn import equivariant as teq

TOL = dict(rtol=1e-6, atol=1e-6)
PATHS = [(l1, l2, l3) for l1 in range(3) for l2 in range(3)
         for l3 in range(3)]


def _unit(n, seed):
    r = np.random.default_rng(seed).normal(size=(n, 3))
    return r / np.linalg.norm(r, axis=-1, keepdims=True)


def test_valid_paths_equal():
    assert teq.valid_paths(2) == jeq.valid_paths(2)
    assert teq.valid_paths(1) == jeq.valid_paths(1)


@pytest.mark.parametrize("l1,l2,l3", PATHS)
def test_cg_tensor_bitwise(l1, l2, l3):
    got, want = teq.cg_tensor(l1, l2, l3), jeq.cg_tensor(l1, l2, l3)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("l", [0, 1, 2])
def test_wigner_and_rotation_bitwise(l):
    R = teq._random_rotation(np.random.default_rng(7))
    assert np.array_equal(R, jeq._random_rotation(np.random.default_rng(7)))
    assert np.array_equal(teq.wigner_d(l, R), jeq.wigner_d(l, R))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_real_sh_np_bitwise(dtype):
    r = _unit(50, 1).astype(dtype)
    got, want = teq.real_sh_np(r, 2), jeq.real_sh_np(r, 2)
    assert sorted(got) == sorted(want)
    for l in got:
        assert got[l].dtype == want[l].dtype
        assert np.array_equal(got[l], want[l])


def test_real_sh_tensor():
    r = _unit(200, 2).astype(np.float32)
    got = teq.real_sh(torch.from_numpy(r), 2)
    want = jeq.real_sh(jnp.asarray(r), 2)
    for l in range(3):
        assert got[l].dtype == torch.float32
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]), **TOL)


@pytest.mark.parametrize("n", [6, 8])
def test_radial_bases(n):
    d = np.concatenate([[0.0, 1e-8, 5.0, 7.5],
                        np.random.default_rng(3).uniform(0, 6, 100)]
                       ).astype(np.float32)
    got = teq.bessel_basis(torch.from_numpy(d), n, 5.0)
    want = jeq.bessel_basis(jnp.asarray(d), n, 5.0)
    assert tuple(got.shape) == want.shape == (d.shape[0], n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        teq.cosine_cutoff(torch.from_numpy(d), 5.0).numpy(),
        np.asarray(jeq.cosine_cutoff(jnp.asarray(d), 5.0)), **TOL)
