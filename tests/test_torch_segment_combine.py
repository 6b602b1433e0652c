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


def _ragged_tile(rows, width, v, d, op, seed, empty_every=0):
    """A frontier-shaped tile: row r's first deg[r] lanes are valid, with
    dst ascending (CSR rows over dst-sorted edges); the rest carry the `v`
    sentinel and identity messages."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, width + 1, rows)
    if empty_every:
        deg[::empty_every] = 0
    dst = np.sort(rng.integers(0, v, (rows, width)), axis=1)
    valid = np.arange(width)[None, :] < deg[:, None]
    dst = np.where(valid, dst, v).astype(np.int32).reshape(-1)
    msgs = rng.normal(size=(rows * width, d)).astype(np.float32)
    msgs[~valid.reshape(-1)] = sc.IDENTITY[op]
    return msgs, dst, int(deg.sum())


def _whole_tile_sort_route(msgs, dst, v, op):
    """The tile route before compaction: a stable sort of every lane
    (sentinels to the tail), then the plain ⊕."""
    dst_sorted, order = torch.sort(dst, stable=True)
    return sc.segment_combine_plain(msgs.index_select(0, order), dst_sorted,
                                    v, op)


@pytest.mark.parametrize("rows,width,v,d,empty_every",
                         [(40, 33, 70, 1, 3), (17, 64, 500, 4, 0),
                          (64, 9, 30, 32, 2), (25, 16, 40, 3, 1)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_tile_route_bitwise_equals_whole_tile_sort(rows, width, v, d,
                                                   empty_every, op):
    """Compacting the valid lanes in lane order before the stable sort
    keeps every segment's lane order, so the route is bitwise the old
    whole-tile sort, sums included; with or without the valid count."""
    msgs, dst, valid = _ragged_tile(rows, width, v, d, op, seed=rows + v,
                                    empty_every=empty_every)
    m, t = torch.from_numpy(msgs), torch.from_numpy(dst)
    want = _whole_tile_sort_route(m, t, v, op)
    for count in (None, valid):
        got = tops.tile_segment_combine(m, t, v, op, valid=count)
        assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_ragged_tile_route_matches_pallas_tile_combine(op):
    """The compacted route on a frontier-shaped tile equals the JAX
    package's tile kernel (interpret mode)."""
    msgs, dst, valid = _ragged_tile(30, 20, 150, 2, op, seed=9, empty_every=4)
    got = tops.tile_segment_combine(torch.from_numpy(msgs),
                                    torch.from_numpy(dst), 150, op, valid)
    want = tile_segment_combine_pallas(jnp.asarray(msgs), jnp.asarray(dst),
                                       150, op, block_e=128, block_v=128,
                                       dynamic=True)
    _assert_combine_equal(got, want, op)


@pytest.mark.parametrize("case", ["ragged", "zero_valid", "all_valid",
                                  "empty", "bad_rows_interleaved"])
def test_plain_compaction_keeps_lane_order(case):
    """`compact_lanes_plain` returns the lanes with dst < num_segments in
    lane order, with their dst, against a numpy count."""
    v = 100
    if case == "ragged":
        _, dst, _ = _ragged_tile(50, 31, v, 1, "min", seed=3, empty_every=5)
    elif case == "zero_valid":
        dst = np.full(777, v, dtype=np.int32)
    elif case == "all_valid":
        dst = np.random.default_rng(4).integers(0, v, 500).astype(np.int32)
    elif case == "empty":
        dst = np.zeros(0, dtype=np.int32)
    else:  # sentinels at and past num_segments, scattered between rows
        dst = np.random.default_rng(5).integers(0, v + 40, 900)
        dst = dst.astype(np.int32)
    got_dst, got_lane = sc.compact_lanes_plain(torch.from_numpy(dst), v)
    keep = np.flatnonzero(dst < v)
    assert got_lane.dtype == torch.int32 and got_dst.dtype == torch.int32
    np.testing.assert_array_equal(got_lane.numpy(), keep)
    np.testing.assert_array_equal(got_dst.numpy(), dst[keep])


def test_tile_route_refuses_a_wrong_valid_count():
    """A valid count that is not the tile's is a broken caller invariant:
    the plain route raises (the kernel traps on the card)."""
    msgs, dst, valid = _ragged_tile(10, 8, 20, 1, "sum", seed=7)
    with pytest.raises(ValueError, match="routed to a segment"):
        tops.tile_segment_combine(torch.from_numpy(msgs),
                                  torch.from_numpy(dst), 20, "sum",
                                  valid=valid + 1)


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


BAD_COMPACT_INPUTS = {
    "int64_dst": (lambda d, n, c: (d.long(), n, c), "int32"),
    "two_dim_dst": (lambda d, n, c: (d.reshape(2, -1), n, c), r"\[N\]"),
    "non_contiguous_dst": (lambda d, n, c: (d[::2], n, c), "contiguous"),
    "negative_valid": (lambda d, n, c: (d, n, -1), "valid must be"),
    "valid_above_lanes": (lambda d, n, c: (d, n, d.shape[0] + 1),
                          "valid must be"),
    "cpu_tensor": (lambda d, n, c: (d, n, c), "CUDA"),
}


@pytest.mark.parametrize("case", sorted(BAD_COMPACT_INPUTS))
def test_compaction_wrapper_refuses_bad_input_before_launch(case,
                                                            monkeypatch):
    """Each bad input to the compaction wrapper raises a clear ValueError
    before any build or launch."""
    def trap(*a, **k):
        raise AssertionError("the wrapper tried to build or launch")

    monkeypatch.setattr(_build, "load", trap)
    before = dict(sc.LAUNCHES)
    dst = torch.tensor([0, 5, 2, 9, 1, 9, 3, 9], dtype=torch.int32)
    mutate, match = BAD_COMPACT_INPUTS[case]
    with pytest.raises(ValueError, match=match):
        sc.compact_lanes_cuda(*mutate(dst, 9, 5))
    assert sc.LAUNCHES == before


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


def _card_cases():
    """(name, route, dst, num_segments, valid) edge cases of the kernels,
    as numpy: every segment empty, a hub of 1,000,000 edges across many
    shares, adjacent hubs, a segment count that is no multiple of a share,
    a ragged tile and a tile with no valid lane."""
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 8, 2048 * 5 + 3)
    counts[100] = 1_000_000
    hubs = np.zeros(2 * 2048 + 1, dtype=np.int64)
    hubs[:4] = 70_001
    _, tile, valid = _ragged_tile(300, 129, 5000, 1, "min", seed=12,
                                  empty_every=3)
    return [
        ("all_empty", "dense", np.zeros(0, np.int32), 3000, None),
        ("all_padding", "dense", np.full(700, 3000, np.int32), 3000, None),
        ("hub_1M", "dense", np.repeat(np.arange(counts.size), counts),
         counts.size, None),
        ("hubs_adjacent", "dense", np.repeat(np.arange(hubs.size), hubs),
         hubs.size, None),
        ("tile_ragged", "tile", tile, 5000, valid),
        ("tile_zero_valid", "tile", np.full(9000, 5000, np.int32), 5000, 0),
    ]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """On a card: the kernel vs the plain version on both routes, bitwise
    for min/max, 1e-5 for sum, and bitwise run to run; then every edge case
    of `_card_cases` at D in {1, 3, 32, 64}, with positive messages (sums
    that cancel have no relative error to hold)."""
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
    rng = np.random.default_rng(13)
    for name, route, dst, v, valid in _card_cases():
        td = torch.from_numpy(dst.astype(np.int32)).cuda()
        if route == "tile":
            got = sc.compact_lanes_cuda(td, v, valid)
            want = sc.compact_lanes_plain(td, v)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        keep = dst < v
        for d in (1, 3, 32, 64):
            msgs = rng.random((dst.size, d)).astype(np.float32)
            tm = torch.from_numpy(msgs).cuda()
            for op in ("sum", "min", "max"):
                if route == "dense":
                    ptr = sc.segment_row_pointer(td, v)
                    a, b = (sc.segment_combine_cuda(tm, td, ptr, v, op)
                            for _ in range(2))
                else:
                    a, b = (sc.tile_segment_combine_cuda(tm, td, v, op, valid)
                            for _ in range(2))
                assert torch.equal(a, b), (name, d, op)
                want = sc.segment_combine_plain(
                    torch.from_numpy(msgs[keep]).double(),
                    torch.from_numpy(dst[keep].astype(np.int32)), v, op)
                if op == "sum":
                    np.testing.assert_allclose(a.cpu().double(), want,
                                               rtol=1e-5, atol=0)
                else:
                    assert torch.equal(a.cpu(), want.float()), (name, d, op)


def _kernel_names(source: str) -> list:
    """Names of the `__global__` functions of a CUDA source of the port."""
    import re
    from pathlib import Path
    text = (Path(_build.CSRC) / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\s*\(", text)


@pytest.mark.parametrize("source", ["segment_combine.cu",
                                    "flash_attention.cu",
                                    "embedding_bag.cu"])
def test_profile_groups_name_every_kernel(source):
    """The profiler's split (`tools/profile_torch_main_path.py`) puts every
    kernel of the port's sources in a named group, so a renamed or new
    kernel cannot fall into "other" unseen."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "tools" / \
        "profile_torch_main_path.py"
    spec = importlib.util.spec_from_file_location("profile_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    names = _kernel_names(source)
    assert names, source
    groups = {n: tool.group_of(f"void (anonymous namespace)::{n}<0>(...)")
              for n in names}
    assert "other" not in groups.values(), groups
