"""The port's ⊕ (plain PyTorch version, the route of every CPU tensor) vs the
JAX package's Pallas segment combine (interpret mode) and its jnp oracle.

Tolerances: min/max must be bitwise, including ±inf in empty segments;
sums are f32 sums taken in another order, so rtol = atol = 1e-5.  The CUDA
kernel itself is held against the plain version by `chip_smoke.py` on the
card; here, the wrapper's input checks run without a build or a launch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.segment_combine import tile_segment_combine_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_combine as sc

SWEEP = [(1000, 8, 64), (512, 1, 300), (2048, 128, 512), (77, 16, 33),
         (256, 32, 256), (4096, 64, 128)]


def _assert_combine_equal(got, want, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if op == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def _dense_case(e, d, v, seed):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, v, e)).astype(np.int32)
    msgs = rng.normal(size=(e, d)).astype(np.float32)
    return msgs, dst


@pytest.mark.parametrize("e,d,v", SWEEP)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_plain_combine_matches_pallas_and_oracle(e, d, v, op):
    msgs, dst = _dense_case(e, d, v, seed=e + d + v)
    got = tops.segment_combine(torch.from_numpy(msgs),
                               torch.from_numpy(dst), v, op)
    pallas = jops.segment_combine(jnp.asarray(msgs), jnp.asarray(dst), v, op)
    oracle = jref.segment_combine_ref(jnp.asarray(msgs), jnp.asarray(dst),
                                      v, op)
    _assert_combine_equal(got, pallas, op)
    _assert_combine_equal(got, oracle, op)


def _tile_case(e, d, v, op, valid_frac, seed):
    """A gathered tile: unsorted dst, invalid lanes with the `v` sentinel
    and identity messages."""
    rng = np.random.default_rng(seed)
    valid = rng.random(e) < valid_frac
    dst = np.where(valid, rng.integers(0, v, e), v).astype(np.int32)
    msgs = rng.normal(size=(e, d)).astype(np.float32)
    msgs[~valid] = sc.IDENTITY[op]
    return msgs, dst


@pytest.mark.parametrize("dynamic", [True, False],
                         ids=["dynamic-table", "full-table"])
@pytest.mark.parametrize("e,d,v,valid_frac", [(600, 4, 130, 0.6),
                                              (1500, 1, 400, 0.3)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_tile_route_matches_pallas_tile_combine(e, d, v, valid_frac, op,
                                                dynamic):
    msgs, dst = _tile_case(e, d, v, op, valid_frac, seed=e + v)
    got = tops.tile_segment_combine(torch.from_numpy(msgs),
                                    torch.from_numpy(dst), v, op)
    want = tile_segment_combine_pallas(jnp.asarray(msgs), jnp.asarray(dst),
                                       v, op, block_e=128, block_v=128,
                                       dynamic=dynamic)
    _assert_combine_equal(got, want, op)
    # the tile route's sort + dense ⊕ is the dense route on sorted input
    order = np.argsort(dst, kind="stable")
    dense = tops.segment_combine(torch.from_numpy(msgs[order]),
                                 torch.from_numpy(dst[order]), v, op)
    _assert_combine_equal(got, dense, op)


def test_payload_shape_and_row_pointer_prefix():
    """`[E, *payload]` messages flatten and come back in shape; a prefix of
    the ingress row pointer serves a smaller segment space (sentinels and
    out-of-range rows drop)."""
    rng = np.random.default_rng(1)
    dst = torch.from_numpy(np.sort(rng.integers(0, 50, 300)).astype(np.int32))
    msgs = torch.from_numpy(rng.normal(size=(300, 2, 3)).astype(np.float32))
    out = tops.segment_combine(msgs, dst, 40, "min",
                               seg_ptr=sc.segment_row_pointer(dst, 50))
    assert out.shape == (40, 2, 3)
    want = sc.segment_combine_plain(msgs.reshape(300, 6), dst, 40, "min")
    assert torch.equal(out.reshape(40, 6), want)
    ptr = sc.segment_row_pointer(dst, 50)
    assert ptr.dtype == torch.int32
    np.testing.assert_array_equal(
        ptr.numpy(), np.searchsorted(dst.numpy(), np.arange(51)))


def _check_random_combine(e, v, d, seed):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, v, e)).astype(np.int32)
    msgs = rng.normal(size=(e, d)).astype(np.float32)
    for op in ("sum", "min", "max"):
        got = tops.segment_combine(torch.from_numpy(msgs),
                                   torch.from_numpy(dst), v, op)
        want = jref.segment_combine_ref(jnp.asarray(msgs), jnp.asarray(dst),
                                        v, op)
        _assert_combine_equal(got, want, op)


@pytest.mark.parametrize("e,v,d,seed", [(1, 1, 1, 0), (500, 200, 32, 1),
                                        (37, 150, 4, 2), (300, 3, 1, 3)])
def test_random_combine_fixed_seeds(e, v, d, seed):
    _check_random_combine(e, v, d, seed)


def test_random_combine_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(e=st.integers(1, 500), v=st.integers(1, 200),
           d=st.sampled_from([1, 4, 32]), seed=st.integers(0, 2**16))
    def check(e, v, d, seed):
        _check_random_combine(e, v, d, seed)

    check()


# ----------------------------------------- the CUDA wrapper's input checks
def _valid_inputs(device="cpu"):
    msgs = torch.zeros(10, 4, device=device)
    dst = torch.arange(10, dtype=torch.int32, device=device) // 3
    return msgs, dst, sc.segment_row_pointer(dst, 4), 4


BAD_INPUTS = {
    "non_contiguous_msgs": (lambda m, d, p, n: (m.t().contiguous().t(), d, p,
                                                n), "contiguous"),
    "float64_msgs": (lambda m, d, p, n: (m.double(), d, p, n), "float32"),
    "one_dim_msgs": (lambda m, d, p, n: (m[:, 0], d, p, n), r"\[E, D\]"),
    "int64_dst": (lambda m, d, p, n: (m, d.long(), p, n), "int32"),
    "short_dst": (lambda m, d, p, n: (m, d[:-1], p, n), r"dst must be \[E\]"),
    "short_seg_ptr": (lambda m, d, p, n: (m, d, p[:-1], n),
                      r"num_segments \+ 1"),
    "long_seg_ptr": (lambda m, d, p, n: (m, d, torch.cat([p, p[-1:]]), n),
                     r"num_segments \+ 1"),
    "int64_seg_ptr": (lambda m, d, p, n: (m, d, p.long(), n), "int32"),
    "cpu_tensors": (lambda m, d, p, n: (m, d, p, n), "CUDA"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_cuda_wrapper_refuses_bad_input_before_launch(case, monkeypatch):
    """Each bad input raises a clear ValueError before any build or
    launch (the build is replaced by a trap); CPU tensors are refused too,
    since they take the plain version."""
    def trap(*a, **k):
        raise AssertionError("the wrapper tried to build or launch")

    monkeypatch.setattr(_build, "load", trap)
    before = dict(sc.LAUNCHES)
    mutate, match = BAD_INPUTS[case]
    with pytest.raises(ValueError, match=match):
        sc.segment_combine_cuda(*mutate(*_valid_inputs()), "min")
    with pytest.raises(ValueError, match="op must be one of"):
        sc.segment_combine_cuda(*_valid_inputs(), "mean")
    assert sc.LAUNCHES == before


def test_plain_combine_is_the_cpu_route():
    """On CPU tensors the dispatch runs the plain version and launches
    nothing."""
    before = dict(sc.LAUNCHES)
    msgs, dst, ptr, n = _valid_inputs()
    msgs = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    out = tops.segment_combine(msgs, dst, n, "max", seg_ptr=ptr)
    assert torch.equal(out, sc.segment_combine_plain(msgs, dst, n, "max"))
    assert out[3].tolist() == [36.0, 37.0, 38.0, 39.0]
    assert sc.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """On a card: the kernel vs the plain version on both routes, bitwise
    for min/max, 1e-5 for sum, and bitwise run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    for op in ("sum", "min", "max"):
        msgs, dst = _dense_case(4096, 32, 300, seed=5)
        m, d = torch.from_numpy(msgs).cuda(), torch.from_numpy(dst).cuda()
        ptr = sc.segment_row_pointer(d, 300)
        with pytest.raises(ValueError, match="seg_ptr"):
            tops.segment_combine(m, d, 300, op)
        a = sc.segment_combine_cuda(m, d, ptr, 300, op)
        b = sc.segment_combine_cuda(m, d, ptr, 300, op)
        assert torch.equal(a, b)
        _assert_combine_equal(a.cpu(), sc.segment_combine_plain(
            m, d, 300, op).cpu(), op)
        tm, td = _tile_case(3000, 1, 200, op, 0.5, seed=6)
        tm, td = torch.from_numpy(tm).cuda(), torch.from_numpy(td).cuda()
        _assert_combine_equal(
            sc.tile_segment_combine_cuda(tm, td, 200, op).cpu(),
            sc.tile_segment_combine_plain(tm, td, 200, op).cpu(), op)
