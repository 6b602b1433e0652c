"""The port's `embedding_bag` (`repro_torch.kernels.ops`: gather, optional
per-id weight, the combine kernel's sum over sorted bag ids; the plain
version on the CPU) against the JAX package's `ops.embedding_bag` (Pallas
segment combine in interpret mode) and its oracle, at
`tests/test_kernels.py`'s shapes.

Also the gradients of `nn.embedding.embedding_bag` (sum and mean, with
and without per-id weights) and `embedding_lookup` against `jax.grad` of
the JAX package's `nn/embedding.py`.

Tolerance: f32 sums taken in another order, rtol = atol = 1e-5 (the JAX
package's own).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_combine as sc

TOL = 1e-5


def _case(seed, n_table=500, d=16, n=200, bags=40):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n_table, d)).astype(np.float32)
    ids = rng.integers(0, n_table, n).astype(np.int32)
    bag_ids = np.sort(rng.integers(0, bags, n)).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    return table, ids, bag_ids, w, bags


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_matches_jax(seed, weighted):
    table, ids, bag_ids, w, bags = _case(seed)
    jw = jnp.asarray(w) if weighted else None
    want = jops.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(bag_ids), bags, weights=jw)
    oracle = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(bag_ids), bags, weights=jw)
    got = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(bag_ids), bags,
                             weights=torch.from_numpy(w) if weighted
                             else None)
    assert got.shape == (bags, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=TOL,
                               atol=TOL)


def test_embedding_bag_row_pointer_and_empty_bags():
    """A caller's row pointer gives the same bags as the one built from the
    bag ids; bags with no id hold zeros."""
    table, ids, bag_ids, w, _ = _case(3, bags=10)
    bags = 13                          # bags 10..12 are empty
    t = {k: torch.from_numpy(v) for k, v in
         (("table", table), ("ids", ids), ("bag", bag_ids), ("w", w))}
    ptr = sc.segment_row_pointer(t["bag"], bags)
    got = tops.embedding_bag(t["table"], t["ids"], t["bag"], bags,
                             weights=t["w"], seg_ptr=ptr)
    same = tops.embedding_bag(t["table"], t["ids"], t["bag"], bags,
                              weights=t["w"])
    assert torch.equal(got, same)
    assert not got[10:].any()
    want = np.zeros((bags, table.shape[1]), np.float64)
    np.add.at(want, bag_ids, table[ids].astype(np.float64) * w[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [True, False])
def test_embedding_bag_gradients_match_jax(mode, weighted):
    """`nn.embedding.embedding_bag`'s table and per-id weight gradients
    (the combine over the ids-sorted order; a row-wise dot product)
    against `jax.grad` of the JAX package's `embedding_bag`."""
    from repro.nn import embedding as jemb
    from repro_torch.nn import embedding as temb
    table, ids, bag_ids, w, bags = _case(4)
    bags += 3                           # empty bags at the end
    cot = np.random.default_rng(5).normal(
        size=(bags, table.shape[1])).astype(np.float32)

    def jloss(t, wt):
        out = jemb.embedding_bag(t, jnp.asarray(ids), jnp.asarray(bag_ids),
                                 bags, mode=mode,
                                 weights=wt if weighted else None)
        return (out * cot).sum(), out

    (_, jout), (jgt, jgw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(table),
                                             jnp.asarray(w))
    t = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = temb.embedding_bag(t, torch.from_numpy(ids),
                             torch.from_numpy(bag_ids), bags, mode=mode,
                             weights=tw if weighted else None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgt), rtol=TOL,
                               atol=TOL)
    if weighted:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw),
                                   rtol=TOL, atol=TOL)
    else:
        assert tw.grad is None


def test_embedding_lookup_gradient_sums_repeated_ids():
    from repro.nn import embedding as jemb
    from repro_torch.nn import embedding as temb
    rng = np.random.default_rng(6)
    table = rng.normal(size=(30, 4)).astype(np.float32)
    ids = rng.integers(0, 30, (5, 7)).astype(np.int32)
    want = jax.grad(lambda t: (jemb.embedding_lookup(t, jnp.asarray(ids))
                               ** 2).sum())(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    got = temb.embedding_lookup(t, torch.from_numpy(ids))
    assert got.shape == (5, 7, 4)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
