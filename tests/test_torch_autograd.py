"""Gradients through the port's kernel entry points
(`repro_torch.kernels.ops`): the combine on both routes and the row
gather, on the CPU, where they run the plain versions.

`torch.autograd.gradcheck` holds each backward against finite differences
in float64; the max/min backward's split of a segment's gradient over the
messages that tie with its result is held against `jax.grad` of
`jax.ops.segment_max`/`segment_min` (the JAX rule the port copies), to
rtol 1e-6.  On the card the same Functions launch the combine kernel; the
test marked `cuda` checks that its output carries a `grad_fn` there.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.kernels import ops
from repro_torch.kernels import segment_combine as sc


def _sorted_case(seed, e=40, d=3, v=9, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, v + 2, e)).astype(np.int32)  # some dropped
    msgs = torch.from_numpy(rng.normal(size=(e, d))).to(dtype)
    return msgs, torch.from_numpy(dst), v


def test_sum_gradcheck_both_routes():
    msgs, dst, v = _sorted_case(0)
    ptr = sc.segment_row_pointer(dst, v)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(
        msgs.shape[0]))
    msgs.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda m: ops.segment_combine(m, dst, v, "sum", seg_ptr=ptr),
        (msgs,))
    assert torch.autograd.gradcheck(
        lambda m: ops.tile_segment_combine(m[perm], dst[perm], v, "sum"),
        (msgs,))


@pytest.mark.parametrize("op", ["max", "min"])
def test_extremal_gradcheck_without_ties(op):
    msgs, dst, v = _sorted_case(2)
    ptr = sc.segment_row_pointer(dst, v)
    msgs.requires_grad_(True)

    def finite(x):    # an empty segment holds the identity, ±inf
        return torch.where(torch.isfinite(x), x, 0.0)
    assert torch.autograd.gradcheck(
        lambda m: finite(ops.segment_combine(m, dst, v, op, seg_ptr=ptr)),
        (msgs,))
    assert torch.autograd.gradcheck(
        lambda m: finite(ops.tile_segment_combine(m, dst, v, op)), (msgs,))


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("route", ["dense", "tile"])
def test_tie_split_matches_jax(op, route):
    """Ties (values repeated within a segment, an identity-valued message,
    dropped lanes) split the gradient as `jax.grad` does."""
    rng = np.random.default_rng(3)
    e, d, v = 60, 2, 8
    dst = np.sort(rng.integers(0, v + 1, e)).astype(np.int32)
    vals = rng.integers(-2, 3, (e, d)).astype(np.float32)   # many ties
    ident = np.inf if op == "min" else -np.inf
    vals[5, 0] = ident
    cot = rng.normal(size=(v, d)).astype(np.float32)
    seg = {"max": jax.ops.segment_max, "min": jax.ops.segment_min}[op]
    want = jax.grad(lambda m: (jnp.where(
        jnp.isfinite(seg(m, jnp.asarray(dst), v)),
        seg(m, jnp.asarray(dst), v), 0.0) * cot).sum())(jnp.asarray(vals))
    m = torch.from_numpy(vals).requires_grad_(True)
    t_dst = torch.from_numpy(dst)
    if route == "dense":
        out = ops.segment_combine(m, t_dst, v, op,
                                  seg_ptr=sc.segment_row_pointer(t_dst, v))
    else:
        perm = torch.from_numpy(rng.permutation(e))
        out = ops.tile_segment_combine(m[perm], t_dst[perm], v, op)
    (torch.where(torch.isfinite(out), out, 0.0)
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_identity_valued_segment_splits_one_more_way():
    """A segment whose every message is the identity keeps the identity as
    its result; JAX counts the initial value as one more tie, so each
    message takes 1/(ties + 1) of the gradient."""
    m = torch.tensor([[-np.inf], [-np.inf], [1.0]], dtype=torch.float64,
                     requires_grad=True)
    dst = torch.tensor([0, 0, 1], dtype=torch.int32)
    out = ops.segment_combine(m, dst, 2, "max",
                              seg_ptr=sc.segment_row_pointer(dst, 2))
    out.backward(torch.ones_like(out))
    assert m.grad[:, 0].tolist() == [1 / 3, 1 / 3, 1.0]
    want = jax.grad(lambda x: jax.ops.segment_max(
        x, jnp.asarray([0, 0, 1]), 2).sum())(
        jnp.asarray([[-np.inf], [-np.inf], [1.0]], jnp.float32))
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want))


def test_row_gather_gradcheck_and_route():
    """`gather_rows` with a route built once and with the route its
    backward builds: the same gradient, a sum over repeated indices."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(7, 3))).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 7, 25).astype(np.int32))
    route = ops.GatherRoute.build(idx, 7)
    assert torch.autograd.gradcheck(
        lambda t: ops.gather_rows(t, idx, route), (table,))
    assert torch.autograd.gradcheck(
        lambda t: ops.gather_rows(t, idx.long()), (table,))
    cot = torch.from_numpy(rng.normal(size=(25, 3)))
    ops.gather_rows(table, idx, route).backward(cot)
    want = np.zeros((7, 3))
    np.add.at(want, idx.numpy(), cot.numpy())
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=1e-12)
    assert route.seg.tolist() == sorted(idx.tolist())


def test_route_sum_gradcheck_and_jax():
    """`route_sum` over an unsorted index on a masked route: gradcheck,
    and the forward and gradient of `jax.ops.segment_sum` of the masked
    rows (indices past the segments are dropped by the mask too)."""
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.normal(size=(30, 2, 3))).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 9, 30).astype(np.int32))
    mask = torch.from_numpy(rng.random(30) < 0.7)
    route = ops.GatherRoute.build(idx, 8, mask=mask & (idx < 8))
    assert torch.autograd.gradcheck(lambda r: ops.route_sum(r, route),
                                    (rows,))
    cot = rng.normal(size=(8, 2, 3))
    ops.route_sum(rows, route).backward(torch.from_numpy(cot))
    keep = mask.numpy()[:, None, None]

    def f(r):
        return jax.ops.segment_sum(jnp.where(keep, r, 0.0),
                                   jnp.asarray(idx.numpy()), 8)
    r64 = jnp.asarray(rows.detach().numpy(), jnp.float32)
    np.testing.assert_allclose(ops.route_sum(rows, route).detach().numpy(),
                               np.asarray(f(r64)), rtol=1e-6, atol=1e-6)
    want = jax.grad(lambda r: (f(r) * cot).sum())(r64)
    np.testing.assert_allclose(rows.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_combine_gradient_skips_dropped_lanes():
    """Lanes routed past the segment space get no gradient on either
    route."""
    msgs, dst, v = _sorted_case(5, dtype=torch.float32)
    dropped = dst >= v
    assert dropped.any()
    ptr = sc.segment_row_pointer(dst, v)
    for combine in (lambda m: ops.segment_combine(m, dst, v, seg_ptr=ptr),
                    lambda m: ops.tile_segment_combine(m, dst, v)):
        m = msgs.clone().requires_grad_(True)
        combine(m).sum().backward()
        assert not m.grad[dropped].any()
        assert (m.grad[~dropped] == 1).all()


@pytest.mark.cuda
def test_kernel_outputs_carry_grad_fn_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the combine kernel runs only "
                    "there (chip_smoke.py holds it on the H100)")
    msgs, dst, v = _sorted_case(6, dtype=torch.float32)
    msgs, dst = msgs.cuda().requires_grad_(True), dst.cuda()
    sc.reset_launches()
    out = ops.segment_combine(msgs, dst, v, "sum",
                              seg_ptr=sc.segment_row_pointer(dst, v))
    assert out.grad_fn is not None
    table = torch.randn(11, 3, device="cuda", requires_grad=True)
    idx = torch.randint(0, 11, (30,), device="cuda", dtype=torch.int32)
    rows = ops.gather_rows(table, idx)
    assert rows.grad_fn is not None
    (out.sum() + rows.sum()).backward()
    assert sc.LAUNCHES["dense"] == 2   # the forward and the gather's backward
    assert msgs.grad is not None and table.grad is not None
