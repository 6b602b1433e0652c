"""The port's EmbeddingBag kernels' plain versions
(`repro_torch.kernels.embedding_bag`) and `ops.embedding_bag`'s autograd
against the JAX package: its `ops.embedding_bag` (the Pallas segment
combine in interpret mode), its oracle `ref.embedding_bag_ref`, and
`jax.grad` of `nn.embedding.embedding_bag` for the table and weight
gradients, at the kernels' edge cases: every width the chip smoke test
holds (d in {1, 3, 16, 64, 100, 128}), empty bags between full ones and
100 trailing, one bag holding every id, one id at every position, ids 0
and N - 1 only, no weights, no id at all, and int32 and int64 ids.

Also the CUDA wrappers refusing bad input before any build or launch, and
one card test of the kernels against the plain versions (skipped without
a card; `chip_smoke.py` makes the same checks on the card).

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
from repro.nn import embedding as jemb
from repro_torch.kernels import _build
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import ops as tops

TOL = 1e-5
DIMS = (1, 3, 16, 64, 100, 128)
CASES = ("gaps", "one_bag", "one_id", "ends", "unweighted", "empty")
N_ROWS, N_IDS, BAGS = 300, 240, 60


def _case(name, d, id_dtype=np.int32, seed=0):
    """(table [N, d], ids, bag ids, weights or None, num_bags) of one edge
    case, from numpy seed `seed`."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N_ROWS, d)).astype(np.float32)
    ids = rng.integers(0, N_ROWS, N_IDS)
    bag_ids = np.sort(rng.integers(0, BAGS, N_IDS))
    w = rng.normal(size=N_IDS).astype(np.float32)
    num_bags = BAGS
    if name == "gaps":                  # two empty bags after each, 100 last
        bag_ids = 3 * bag_ids
        num_bags = 3 * BAGS + 100
    elif name == "one_bag":
        bag_ids = np.zeros(N_IDS, np.int64)
        num_bags = 2
    elif name == "one_id":
        ids = np.full(N_IDS, 7)
    elif name == "ends":
        ids = np.where(rng.random(N_IDS) < 0.5, 0, N_ROWS - 1)
    elif name == "unweighted":
        w = None
    elif name == "empty":
        ids, bag_ids, w = ids[:0], bag_ids[:0], w[:0]
    return (table, ids.astype(id_dtype), bag_ids.astype(np.int32), w,
            num_bags)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _jax_forward(table, ids, bag_ids, w, num_bags):
    jw = None if w is None else jnp.asarray(w)
    args = (jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bag_ids),
            num_bags)
    return (np.asarray(jops.embedding_bag(*args, weights=jw)),
            np.asarray(jref.embedding_bag_ref(*args, weights=jw)))


def _jax_grads(table, ids, bag_ids, w, num_bags, cot):
    """jax.grad of `<embedding_bag(table, weights), cot>` in the table and
    (where given) the weights."""
    def loss(t, wt):
        return (jemb.embedding_bag(t, jnp.asarray(ids), jnp.asarray(bag_ids),
                                   num_bags, weights=wt) * cot).sum()
    if w is None:
        return np.asarray(jax.grad(loss)(jnp.asarray(table), None)), None
    gt, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                            jnp.asarray(w))
    return np.asarray(gt), np.asarray(gw)


def _cot(num_bags, d, seed=1):
    return np.random.default_rng(seed).normal(
        size=(num_bags, d)).astype(np.float32)


def _forward_against_jax(name, d, id_dtype):
    table, ids, bag_ids, w, num_bags = _case(name, d, id_dtype)
    want, oracle = _jax_forward(table, ids, bag_ids, w, num_bags)
    got = eb.embedding_bag_forward_plain(*_torch(table, ids, bag_ids),
                                         num_bags, *_torch(w))
    assert got.shape == (num_bags, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=TOL, atol=TOL)
    if name == "gaps":
        used = np.zeros(num_bags, bool)
        used[bag_ids] = True
        assert not got[torch.from_numpy(~used)].any()
    return got


def _backward_against_jax(name, d, id_dtype):
    table, ids, bag_ids, w, num_bags = _case(name, d, id_dtype)
    cot = _cot(num_bags, d)
    want_t, want_w = _jax_grads(table, ids, bag_ids, w, num_bags, cot)
    g_t, g_w = eb.embedding_bag_backward_plain(
        *_torch(cot, table, ids, bag_ids), num_bags, *_torch(w),
        need_table=True, need_weights=w is not None)
    assert g_t.shape == (N_ROWS, d) and g_t.dtype == torch.float32
    np.testing.assert_allclose(g_t.numpy(), want_t, rtol=TOL, atol=TOL)
    if w is None:
        assert g_w is None
    else:
        assert g_w.shape == (ids.shape[0],)
        np.testing.assert_allclose(g_w.numpy(), want_w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("d", DIMS)
def test_plain_forward_matches_jax(name, d):
    _forward_against_jax(name, d, np.int32)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("d", DIMS)
def test_plain_backward_matches_jax(name, d):
    _backward_against_jax(name, d, np.int32)


@pytest.mark.parametrize("d", DIMS)
def test_plain_versions_take_int64_ids(d):
    got = _forward_against_jax("gaps", d, np.int64)
    same = _forward_against_jax("gaps", d, np.int32)
    assert torch.equal(got, same)
    _backward_against_jax("gaps", d, np.int64)


@pytest.mark.parametrize("wrt", ["table", "weights", "both"])
@pytest.mark.parametrize("d", [3, 16])
def test_ops_autograd_computes_only_the_gradients_asked_for(wrt, d,
                                                            monkeypatch):
    """`ops.embedding_bag` on the CPU: its output equals the plain
    forward's, each gradient asked for equals jax.grad's, and the backward
    is told to skip the others (no table gradient when only the weights
    train)."""
    table, ids, bag_ids, w, num_bags = _case("gaps", d)
    cot = _cot(num_bags, d)
    want_t, want_w = _jax_grads(table, ids, bag_ids, w, num_bags, cot)
    calls = []
    plain = eb.embedding_bag_backward_plain

    def spy(*args):
        calls.append(args[-2:])
        return plain(*args)
    monkeypatch.setattr(eb, "embedding_bag_backward_plain", spy)
    t, i, b, tw = _torch(table, ids, bag_ids, w)
    t.requires_grad_(wrt in ("table", "both"))
    tw.requires_grad_(wrt in ("weights", "both"))
    out = tops.embedding_bag(t, i, b, num_bags, weights=tw)
    assert torch.equal(out.detach(), eb.embedding_bag_forward_plain(
        t.detach(), i, b, num_bags, tw.detach()))
    (out * torch.from_numpy(cot)).sum().backward()
    assert calls == [(wrt != "weights", wrt != "table")]
    if wrt == "weights":
        assert t.grad is None
    else:
        np.testing.assert_allclose(t.grad.numpy(), want_t, rtol=TOL,
                                   atol=TOL)
    if wrt == "table":
        assert tw.grad is None
    else:
        np.testing.assert_allclose(tw.grad.numpy(), want_w, rtol=TOL,
                                   atol=TOL)


def test_ops_autograd_without_weights_and_with_no_ids():
    """No weights: only the table gradient; no id at all: zero bags and a
    zero table gradient."""
    for name in ("unweighted", "empty"):
        table, ids, bag_ids, w, num_bags = _case(name, 16)
        cot = _cot(num_bags, 16)
        t, i, b, tw = _torch(table, ids, bag_ids, w)
        t.requires_grad_(True)
        out = tops.embedding_bag(t, i, b, num_bags, weights=tw)
        (out * torch.from_numpy(cot)).sum().backward()
        want_t, _ = _jax_grads(table, ids, bag_ids, w, num_bags, cot)
        np.testing.assert_allclose(t.grad.numpy(), want_t, rtol=TOL,
                                   atol=TOL)
    assert not out.any() and not t.grad.any()


def _good():
    """Arguments the CUDA wrappers take, but for lying on the CPU."""
    return {"table": torch.zeros((20, 16)),
            "ids": torch.zeros(8, dtype=torch.int32),
            "bag_ids": torch.zeros(8, dtype=torch.int32),
            "num_bags": 3,
            "weights": torch.ones(8)}


BAD_INPUTS = {
    "cpu_tensor": ({}, "needs CUDA tensors"),
    "float64_weights": ({"weights": torch.ones(8, dtype=torch.float64)},
                        "weights must be float32"),
    "float64_table": ({"table": torch.zeros((20, 16), dtype=torch.float64)},
                      "table must be float32"),
    "non_contiguous_table": ({"table": torch.zeros((16, 20)).t()},
                             "table must be contiguous"),
    "non_contiguous_ids": ({"ids": torch.zeros(16, dtype=torch.int32)[::2]},
                           "ids must be a contiguous"),
    "mismatched_bag_ids": ({"bag_ids": torch.zeros(7, dtype=torch.int32)},
                           "bag_ids must be"),
    "mismatched_weights": ({"weights": torch.ones(9)}, "weights must be"),
    "int64_bag_ids": ({"bag_ids": torch.zeros(8, dtype=torch.int64)},
                      "bag_ids must be int32"),
    "float_ids": ({"ids": torch.zeros(8)}, "ids must be int32 or int64"),
    "3d_table": ({"table": torch.zeros((20, 4, 4))}, "table must be"),
    "negative_num_bags": ({"num_bags": -1}, "num_bags must be"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_cuda_wrappers_refuse_bad_input_before_any_build(case, direction,
                                                         monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} before checking the input")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(eb, "_LIB", None)
    change, match = BAD_INPUTS[case]
    args = {**_good(), **change}
    before = dict(eb.LAUNCHES)
    if direction == "forward":
        with pytest.raises(ValueError, match=match):
            eb.embedding_bag_forward_cuda(**args)
    else:
        nb = max(args["num_bags"], 0)
        grad = torch.zeros((nb, args["table"].shape[-1]))
        with pytest.raises(ValueError, match=match):
            eb.embedding_bag_backward_cuda(grad, **args)
    assert eb.LAUNCHES == before


def test_cuda_backward_refuses_a_bad_gradient(monkeypatch):
    monkeypatch.setattr(eb, "_LIB", None)
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("built"))
    args = _good()
    for grad, match in ((torch.zeros((3, 15)), "grad must be float32"),
                        (torch.zeros((16, 3)).t(), "grad must be contiguous"),
                        (torch.zeros((3, 16), dtype=torch.float64),
                         "grad must be float32")):
        with pytest.raises(ValueError, match=match):
            eb.embedding_bag_backward_cuda(grad, **args)
    args["weights"] = None
    with pytest.raises(ValueError, match="need_weights without weights"):
        eb.embedding_bag_backward_cuda(torch.zeros((3, 16)), **args)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_card():
    """On a card: both kernels at every edge case and width against the
    plain versions in float64 (positive inputs, rtol 1e-5), two launches
    bitwise equal, one forward and one backward launch through
    `ops.embedding_bag` and no combine-kernel launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from repro_torch.kernels import segment_combine as sc
    for d in DIMS:
        for name in CASES:
            table, ids, bag_ids, w, num_bags = _case(name, d)
            table, w = np.abs(table), None if w is None else np.abs(w)
            cot = np.abs(_cot(num_bags, d))
            t, i, b, tw, c = (None if x is None else x.cuda() for x in
                              _torch(table, ids, bag_ids, w, cot))
            outs = [eb.embedding_bag_forward_cuda(t, i, b, num_bags, tw)
                    for _ in range(2)]
            grads = [eb.embedding_bag_backward_cuda(
                c, t, i, b, num_bags, tw, True, tw is not None)
                for _ in range(2)]
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[1]), (name, d)
            want = eb.embedding_bag_forward_plain(
                t.double(), i, b, num_bags,
                None if tw is None else tw.double())
            np.testing.assert_allclose(outs[0].cpu().double(), want.cpu(),
                                       rtol=TOL, atol=0)
            want_t, want_w = eb.embedding_bag_backward_plain(
                c.double(), t.double(), i, b, num_bags,
                None if tw is None else tw.double(), True, tw is not None)
            for got, again, ref in zip(grads[0], grads[1], (want_t, want_w)):
                if ref is None:
                    assert got is None
                    continue
                assert torch.equal(got, again), (name, d)
                np.testing.assert_allclose(got.cpu().double(), ref.cpu(),
                                           rtol=TOL, atol=0)
    table, ids, bag_ids, w, num_bags = _case("gaps", 16)
    t, i, b, tw = (x.cuda() for x in _torch(table, ids, bag_ids, w))
    t.requires_grad_(True)
    eb.reset_launches()
    sc.reset_launches()
    tops.embedding_bag(t, i, b, num_bags, weights=tw).sum().backward()
    torch.cuda.synchronize()
    assert eb.LAUNCHES == {"forward": 1, "backward": 1}
    assert sc.LAUNCHES == {"dense": 0, "tile": 0, "compact": 0}
