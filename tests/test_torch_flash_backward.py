"""The backward of the port's flash attention (K3) against the JAX
package's: `flash_attention_bwd_plain`, and `ops.flash_attention` /
`gqa_attention(impl="chunked")` under autograd on the CPU, vs `jax.grad`
of `flash_attention_jax` (its hand-written `custom_vjp` backward,
`_flash_bwd_rule`) and of `_gqa_scores_ref`, on the same numpy inputs.

Tolerance: float32 dQ, dK, dV within 2e-5 absolute plus 1e-4 relative.
Both sides compute the same products in float32, but in another order
(the JAX backward sums block by block over chunks of 64; the plain
version sums the whole score matrix at once), and dS = p·(dO·vᵀ − δ)
cancels where a row's probabilities are near one-hot.

In bfloat16 the plain version rounds p and dS where `_flash_bwd_rule`
does (`p.astype(q.dtype)` before dV, `ds.astype(q.dtype)` before dK and
dQ), as the kernel's tensor cores take them; the tests hold that against
an independent float64 evaluation of the formulas, and the whole bf16
gradient against `jax.grad` in bf16 with JAX's own bf16 error as the
yardstick (its block accumulators are bf16 too).  The CUDA kernel
itself is held against the plain version by `chip_smoke.py` on the card
and by the `cuda`-marked test here on a machine that has one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.nn import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.nn import attention as tattn

TOL = dict(rtol=1e-4, atol=2e-5)

# B, Sq, Sk, Kv, G, H, causal
CASES = {
    "causal_g3_h64": (2, 96, 96, 2, 3, 64, True),
    "noncausal_sq_lt_sk": (2, 100, 300, 2, 3, 32, False),
    "causal_sq_gt_sk": (2, 300, 100, 1, 1, 32, True),
    "causal_sq_lt_sk": (2, 80, 160, 2, 1, 16, True),
    "ragged_1000": (2, 1000, 1000, 1, 3, 64, True),
    "g8_h128": (2, 130, 130, 1, 8, 128, True),
    "g1_h16_noncausal": (2, 70, 70, 3, 1, 16, False),
}


def _inputs(case, seed=0):
    b, sq, sk, kv, g, h, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, kv, g, h)).astype(np.float32),
            rng.normal(size=(b, sk, kv, h)).astype(np.float32),
            rng.normal(size=(b, sk, kv, h)).astype(np.float32),
            rng.normal(size=(b, sq, kv, g, h)).astype(np.float32))


def _jax_grads(fn, q, k, v, do):
    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_) * do)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _torch_grads(fn, q, k, v, do):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    fn(tq, tk, tv).backward(torch.from_numpy(do))
    return [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_flash_backward(case):
    """`ops.flash_attention` under autograd (plain forward with `lse`,
    plain backward) against `jax.grad` of `flash_attention_jax` at chunks
    of 64, so the JAX backward runs several blocks and a ragged tail."""
    causal = CASES[case][-1]
    q, k, v, do = _inputs(case)
    want = _jax_grads(lambda a, b, c: jattn.flash_attention_jax(
        a, b, c, causal, 64, 64), q, k, v, do)
    got = _torch_grads(lambda a, b, c: ops.flash_attention(a, b, c, causal),
                       q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_attention_gradient_matches_the_reference_gradient(case):
    """`gqa_attention(impl="chunked")` under autograd against `jax.grad`
    of the full-matrix reference `_gqa_scores_ref`."""
    causal = CASES[case][-1]
    q, k, v, do = _inputs(case, seed=1)
    want = _jax_grads(lambda a, b, c: jattn._gqa_scores_ref(a, b, c, causal),
                      q, k, v, do)
    got = _torch_grads(lambda a, b, c: tattn.gqa_attention(
        a, b, c, causal, impl="chunked"), q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("case", ["causal_g3_h64", "noncausal_sq_lt_sk",
                                  "ragged_1000"])
def test_bwd_plain_on_jax_residuals(case):
    """`flash_attention_bwd_plain` fed the JAX forward's own o and
    lse = m + log l (`_flash_fwd_stats`) returns JAX's dQ, dK, dV; the
    plain forward's lse is JAX's m + log l."""
    causal = CASES[case][-1]
    q, k, v, do = _inputs(case, seed=2)
    o, m, l = jattn._flash_fwd_stats(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal, 64, 64)
    lse = np.asarray(m) + np.log(np.asarray(l))
    _, tlse = fa.flash_attention_plain(*(torch.from_numpy(a)
                                         for a in (q, k, v)), causal,
                                       return_lse=True)
    np.testing.assert_allclose(tlse.numpy(), lse, rtol=1e-5, atol=1e-5)
    want = _jax_grads(lambda a, b, c: jattn.flash_attention_jax(
        a, b, c, causal, 64, 64), q, k, v, do)
    got = fa.flash_attention_bwd_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, do)),
        causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_autograd_only_when_a_gradient_is_wanted():
    """Without a gradient `ops.flash_attention` is the forward alone (no
    graph, the same bits); with one, the Function records and its output
    equals the forward's."""
    q, k, v, _ = _inputs("causal_g3_h64")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = fa.flash_attention_plain(tq, tk, tv, True)
    assert torch.equal(ops.flash_attention(tq, tk, tv, True), plain)
    out = ops.flash_attention(tq.requires_grad_(True), tk, tv, True)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv, True).grad_fn is None


BF16_CASES = ["causal_g3_h64", "noncausal_sq_lt_sk", "causal_sq_gt_sk",
              "g8_h128"]


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def _formulas(q, k, v, o, lse, do, causal, rounded):
    """dQ, dK, dV in bf16 from the backward's formulas, written apart from
    the plain version: p and dS in float32 (rounded to bf16 when
    `rounded`), every product in float64 over [B, Kv, G, Sq, Sk]."""
    h = q.shape[-1]
    qh = q.double().permute(0, 2, 3, 1, 4)                 # [B, Kv, G, Sq, H]
    doh = do.double().permute(0, 2, 3, 1, 4)
    kh = k.double().permute(0, 2, 1, 3)[:, :, None]        # [B, Kv, 1, Sk, H]
    vh = v.double().permute(0, 2, 1, 3)[:, :, None]
    s = (qh @ kh.transpose(-1, -2)).float() / np.float32(np.sqrt(h))
    sq, sk = q.shape[1], k.shape[1]
    seen = (torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]
            if causal else torch.ones(sq, sk, dtype=torch.bool))
    p = torch.where(seen, torch.exp(s - lse[..., None]), torch.zeros(()))
    dp = (doh @ vh.transpose(-1, -2)).float()
    delta = (doh * o.double().permute(0, 2, 3, 1, 4)).sum(-1).float()
    ds = p * (dp - delta[..., None]) / np.float32(np.sqrt(h))
    if rounded:
        p, ds = p.bfloat16(), ds.bfloat16()
    p, ds = p.double(), ds.double()
    dq = (ds @ kh).permute(0, 3, 1, 2, 4)
    dk = (ds.transpose(-1, -2) @ qh).sum(2).permute(0, 2, 1, 3)
    dv = (p.transpose(-1, -2) @ doh).sum(2).permute(0, 2, 1, 3)
    return [t.bfloat16() for t in (dq, dk, dv)]


@pytest.mark.parametrize("case", ["causal_g3_h64", "noncausal_sq_lt_sk",
                                  "g8_h128"])
def test_bf16_plain_rounds_p_and_ds_where_jax_does(case):
    """In bf16 `flash_attention_bwd_plain` is the float32 formulas with p
    and dS rounded to bf16: at least 99% of its entries have the bits of
    an independent evaluation with those roundings (the two compute s and
    the sums in another order, so a rare rounding of p or dS goes the
    other way; measured 99.75-99.99%).  Without the roundings the formulas
    give the same bits in only about 58% of the entries."""
    causal = CASES[case][-1]
    q, k, v, do = (_bf16(a) for a in _inputs(case, seed=3))
    o, lse = fa.flash_attention_plain(q, k, v, causal, return_lse=True)
    got = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    rounded = _formulas(q, k, v, o, lse, do, causal, True)
    unrounded = _formulas(q, k, v, o, lse, do, causal, False)
    for g, r, u in zip(got, rounded, unrounded):
        assert g.dtype == torch.bfloat16
        assert (g == r).float().mean() >= 0.99
        assert (g == u).float().mean() <= 0.8


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_backward_matches_jax_bf16_backward(case):
    """`ops.flash_attention` under autograd in bf16 (plain forward and
    backward) against `jax.grad` of `flash_attention_jax` in bf16 on the
    same bf16 inputs.  The yardstick is JAX's own bf16 error, its largest
    distance to JAX's float32 gradient: JAX rounds each block's product
    and its running sum to bf16 (`src/repro/nn/attention.py`, the
    accumulators of `dq_block` and `dkv_block`), the port sums in float32
    and rounds once.  The port must lie within twice that distance of
    JAX's bf16 gradient and within 1.5 times it of the float32 one (both
    measured at most 1.55 and 1.3 on these cases)."""
    causal = CASES[case][-1]
    q, k, v, do = (_bf16(a) for a in _inputs(case))
    tq, tk, tv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ops.flash_attention(tq, tk, tv, causal).backward(do)
    got = [t.grad.float().numpy() for t in (tq, tk, tv)]
    x = [t.float().numpy() for t in (q, k, v, do)]
    want32 = _jax_grads(lambda a, b, c: jattn.flash_attention_jax(
        a, b, c, causal, 64, 64), *x)

    def loss(a, b, c):
        o = jattn.flash_attention_jax(a, b, c, causal, 64, 64)
        return jnp.sum((o * jnp.asarray(x[3], jnp.bfloat16)).astype(
            jnp.float32))
    want16 = [np.asarray(g, np.float32) for g in jax.grad(
        loss, argnums=(0, 1, 2))(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in x[:3]))]
    for g, w16, w32 in zip(got, want16, want32):
        jax_err = np.abs(w16 - w32).max()
        assert jax_err > 0
        assert np.abs(g - w16).max() <= 2.0 * jax_err
        assert np.abs(g - w32).max() <= 1.5 * jax_err


def _misaligned(t):
    """A contiguous copy of `t` 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)[1:]
    return flat[:t.numel()].view(t.shape)


def _valid(dtype=torch.float32):
    q = torch.zeros(2, 12, 2, 3, 64, dtype=dtype)
    k = torch.zeros(2, 12, 2, 64, dtype=dtype)
    lse = torch.zeros(2, 2, 3, 12)
    return q, k, k.clone(), q.clone(), lse, q.clone()


BAD_BWD = {
    "lse_shape": (lambda q, k, v, o, lse, do: (q, k, v, o, lse[..., :5], do),
                  "lse must be float32"),
    "lse_dtype": (lambda q, k, v, o, lse, do: (q, k, v, o, lse.double(), do),
                  "lse must be float32"),
    "dout_shape": (lambda q, k, v, o, lse, do: (q, k, v, o, lse, do[:, :5]),
                   "dout must match"),
    "o_dtype": (lambda q, k, v, o, lse, do: (q, k, v, o.bfloat16(), lse, do),
                "o must match"),
    "dout_non_contiguous": (lambda q, k, v, o, lse, do: (
        q, k, v, o, lse, do.transpose(1, 2).contiguous().transpose(1, 2)),
        "dout must be contiguous"),
    "head_dim_48": (lambda q, k, v, o, lse, do: (
        *(t[..., :48].contiguous() for t in (q, k, v, o)), lse,
        do[..., :48].contiguous()), "head dim"),
    "dout_misaligned": (lambda q, k, v, o, lse, do: (
        q, k, v, o, lse, _misaligned(do)), "dout must be 16-byte aligned"),
    "cpu_tensors": (lambda *a: a, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(BAD_BWD))
def test_bwd_wrapper_refuses_bad_input_before_launch(case, monkeypatch):
    """Each bad input raises a ValueError before any build or launch (the
    build is replaced by a trap), and the launch count stays."""
    def trap(*a, **k):
        raise AssertionError("the wrapper tried to build or launch")

    monkeypatch.setattr(_build, "load", trap)
    before = fa.LAUNCHES_BWD
    mutate, match = BAD_BWD[case]
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd_cuda(*mutate(*_valid()))
    assert fa.LAUNCHES_BWD == before


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    """On a card: K3 forward with `lse` and the backward kernel against
    the plain versions, f32 (TF32 off) and bf16, ragged, Sq != Sk, G = 1
    and 8, every head dim; two launches bitwise equal.  The limits are
    `chip_smoke.bwd_error_ratio`'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    for dt in (torch.float32, torch.bfloat16):
        for case in sorted(CASES):
            b, sq, sk, kv, g, h, causal = CASES[case]
            q, k, v, do = (torch.from_numpy(a).to("cuda", dt)
                           for a in _inputs(case))
            o, lse = fa.flash_attention_cuda(q, k, v, causal,
                                             return_lse=True)
            before = fa.LAUNCHES_BWD
            chip_smoke.hold_attention_backward(case, q, k, v, o, lse, do,
                                               causal)
            assert fa.LAUNCHES_BWD == before + 2
