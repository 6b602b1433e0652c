"""The port's LM layers and attention (plain PyTorch on the CPU) vs the JAX
package, on the same numpy inputs.

Tolerances, all in float32: elementwise layers (RoPE, RMSNorm, the FFN)
within 1e-6, since they do the same float32 operations in the same order
and differ only in the last bits of transcendental functions and matmul
summation; the full-matrix and flash attention paths within 2e-5 (the JAX
package's own tolerance for flash vs reference, tests/test_attention.py);
decode attention within 1e-5 (tests/test_attention.py).  bf16 within
two bf16 ulps of each element plus 3% of its row's RMS
(`torch_parity.bf16_attention_error_ratio`; the JAX package's 3e-2 is
as large as the outputs of late causal rows).  The CUDA kernel itself is held against the plain
version by `chip_smoke.py` on the card, and by the `cuda`-marked test here
on a machine that has one.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.nn import attention as jattn
from repro.nn import ffn as jffn
from repro.nn import layers as jlayers
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.nn import attention as tattn
from repro_torch.nn import ffn as tffn
from repro_torch.nn import layers as tlayers
from torch_parity import bf16_attention_error_ratio


def _rand(rng, shape, dtype=np.float32):
    return rng.normal(size=shape).astype(dtype)


def _qkv(seed, b, sq, sk, kv, g, h):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (b, sq, kv, g, h)), _rand(rng, (b, sk, kv, h)),
            _rand(rng, (b, sk, kv, h)))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ------------------------------------------------------------ small layers
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 3, 17, 64))
    pos = rng.integers(0, 4096, size=(2, 1, 17))
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_apply_rope_rotates_interleaved_pairs():
    """Position 1 rotates (x0, x1) by freq 1 rad: the interleaved pairing,
    not the half-split one."""
    x = torch.zeros(1, 1, 8)
    x[0, 0, 0] = 1.0
    y = tattn.apply_rope(x, torch.ones(1, 1))
    assert torch.allclose(y[0, 0, :2], torch.tensor([np.cos(1.0),
                                                      np.sin(1.0)]).float())
    assert torch.count_nonzero(y[0, 0, 2:]) == 0


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(1)
    x, gamma = _rand(rng, (3, 5, 96)), _rand(rng, (96,))
    got = tlayers.rmsnorm(*_t(x, gamma))
    want = jlayers.rmsnorm(*_j(x, gamma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("activation,gated", [("silu", True),
                                              ("squared_relu", False),
                                              ("gelu", True)])
def test_ffn_apply_matches_jax(activation, gated):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    params = {"w_in": _rand(rng, (d, f)) / 6, "w_out": _rand(rng, (f, d)) / 7}
    if gated:
        params["w_gate"] = _rand(rng, (d, f)) / 6
    x = _rand(rng, (2, 7, d))
    got = tffn.ffn_apply({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x), activation)
    want = jffn.ffn_apply({k: jnp.asarray(v) for k, v in params.items()},
                          jnp.asarray(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("s,qc,kc", [(96, 32, 32), (128, 128, 64),
                                     (100, 32, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_attention_matches_jax(s, qc, kc, causal):
    """Both impls at the shapes of the JAX package's flash tests: the
    port's reference against JAX's, and its chunked path (the plain
    version on the CPU) against `flash_attention_jax`, padding included."""
    q, k, v = _qkv(s + qc + kc, 2, s, s, 2, 3, 16)
    tq, tk, tv = _t(q, k, v)
    jq, jk, jv = _j(q, k, v)
    ref = tattn.gqa_attention(tq, tk, tv, causal, impl="reference")
    want_ref = jattn._gqa_scores_ref(jq, jk, jv, causal)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want_ref),
                               rtol=2e-5, atol=2e-5)
    chunked = tattn.gqa_attention(tq, tk, tv, causal, impl="chunked")
    want = jattn.flash_attention_jax(jq, jk, jv, causal, qc, kc)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        tattn.gqa_attention(tq, tk, tv, causal, impl="pallas")


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = _rand(rng, (3, 1, 2, 3, 16))
    kc, vc = _rand(rng, (3, 32, 2, 16)), _rand(rng, (3, 32, 2, 16))
    lens = np.array([24, 0, 40], np.int32)    # 40 >= S: every row valid
    got = tattn.decode_attention(*_t(q, kc, vc), torch.from_numpy(lens))
    want = jattn.decode_attention(*_j(q, kc, vc), jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# The four shapes of tests/test_kernels.py::test_flash_attention_sweep.
KERNEL_SWEEP = [(2, 128, 128, 2, 2, 64, True), (1, 256, 256, 1, 4, 32, True),
                (2, 128, 128, 2, 1, 64, False), (1, 64, 192, 2, 2, 32, False)]


@pytest.mark.parametrize("b,sq,sk,kv,g,h,causal", KERNEL_SWEEP)
def test_ops_flash_attention_matches_pallas(b, sq, sk, kv, g, h, causal):
    """The port's K3 wrapper (plain version on a CPU tensor) vs the JAX
    package's GQA wrapper over the Pallas kernel in interpret mode."""
    q, k, v = _qkv(sq + sk + h, b, sq, sk, kv, g, h)
    got = tops.flash_attention(*_t(q, k, v), causal=causal)
    want = jops.flash_attention(*_j(q, k, v), causal=causal, block_q=64,
                                block_k=64)
    assert got.shape == (b, sq, kv, g, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("s,causal", [(100, True), (77, False)])
def test_ops_flash_attention_ragged_length(s, causal):
    """A length no tile divides: the Pallas kernel refuses it, so the
    reference is the JAX package's padded flash path."""
    q, k, v = _qkv(s, 2, s, s, 3, 2, 32)
    got = tops.flash_attention(*_t(q, k, v), causal=causal)
    want = jattn.flash_attention_jax(*_j(q, k, v), causal, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ops_flash_attention_bf16_matches_pallas():
    q, k, v = _qkv(5, 1, 128, 128, 1, 2, 32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    assert bf16_attention_error_ratio(got.float(), np.asarray(
        want, np.float32)) <= 1.0


# ----------------------------------------- the CUDA wrapper's input checks
def _valid(device="cpu", dtype=torch.float32):
    q = torch.zeros(2, 8, 2, 3, 64, device=device, dtype=dtype)
    k = torch.zeros(2, 12, 2, 64, device=device, dtype=dtype)
    return q, k, k.clone()


BAD_INPUTS = {
    "four_dim_q": (lambda q, k, v: (q[:, :, :, 0], k, v), r"\[B, Sq, Kv, G, H\]"),
    "kv_heads_differ": (lambda q, k, v: (q, k[:, :, :1], v[:, :, :1]),
                        r"\[B, Sk, Kv, H\]"),
    "k_v_lengths_differ": (lambda q, k, v: (q, k, v[:, :5]), r"\[B, Sk, Kv, H\]"),
    "float64": (lambda q, k, v: (q.double(), k.double(), v.double()),
                "float32 or bfloat16"),
    "mixed_dtypes": (lambda q, k, v: (q, k.bfloat16(), v), "share a dtype"),
    "head_dim_48": (lambda q, k, v: (q[..., :48], k[..., :48], v[..., :48]),
                    "head dim"),
    "empty_kv": (lambda q, k, v: (q, k[:, :0], v[:, :0]), "empty"),
    "non_contiguous_q": (lambda q, k, v: (q.transpose(1, 2).contiguous()
                                          .transpose(1, 2), k, v),
                         "contiguous"),
    "misaligned_q": (lambda q, k, v: (torch.zeros(q.numel() + 1)[1:].view(
        q.shape), k, v), "16-byte aligned"),
    "cpu_tensors": (lambda q, k, v: (q, k, v), "CUDA"),
    # the bf16 kernel's TMA maps need 16-byte aligned bases: v 8 bytes off
    "misaligned_v_bf16": (lambda q, k, v: (
        q.bfloat16(), k.bfloat16(),
        torch.zeros(v.numel() + 4, dtype=torch.bfloat16)[4:].view(v.shape)),
        "v must be 16-byte aligned"),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_cuda_wrapper_refuses_bad_input_before_launch(case, monkeypatch):
    """Each bad input raises a ValueError before any build or launch (the
    build is replaced by a trap); CPU tensors are refused too, since they
    take the plain version."""
    def trap(*a, **k):
        raise AssertionError("the wrapper tried to build or launch")

    monkeypatch.setattr(_build, "load", trap)
    before = fa.LAUNCHES
    mutate, match = BAD_INPUTS[case]
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_cuda(*mutate(*_valid()))
    assert fa.LAUNCHES == before


def test_cpu_tensors_take_the_plain_version():
    before = fa.LAUNCHES
    q, k, v = _qkv(9, 1, 16, 16, 1, 2, 16)
    got = tops.flash_attention(*_t(q, k, v))
    assert torch.equal(got, fa.flash_attention_plain(*_t(q, k, v)))
    assert fa.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card():
    """On a card: the kernel vs the plain version, f32 (TF32 off) at 2e-5
    and bf16 within `bf16_attention_error_ratio`'s limit, ragged and
    Sq != Sk included, bitwise run to run.  The bf16 cases take the wgmma
    kernel's corners: every head dim, G = 1 and G = 8 (three shares of a
    kv head's query heads, the last one short), and B = 2 at a ragged
    length, where a TMA map that read the next batch's rows would show."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(2, 128, 128, 2, 2, 64, True, torch.float32),
             (1, 64, 192, 2, 2, 32, False, torch.float32),
             (1, 100, 100, 3, 3, 16, True, torch.float32),
             (2, 300, 300, 3, 3, 64, True, torch.bfloat16),
             (1, 130, 130, 2, 2, 128, True, torch.bfloat16),
             (2, 300, 1000, 2, 3, 64, False, torch.bfloat16),
             (2, 256, 256, 2, 2, 16, True, torch.bfloat16),
             (2, 256, 256, 2, 2, 32, True, torch.bfloat16),
             (2, 256, 256, 4, 1, 64, True, torch.bfloat16),
             (1, 256, 256, 2, 8, 64, True, torch.bfloat16),
             (2, 1000, 1000, 3, 3, 64, True, torch.bfloat16)]
    for b, sq, sk, kv, g, h, causal, dt in cases:
        q, k, v = (torch.from_numpy(a).to("cuda", dt)
                   for a in _qkv(sq, b, sq, sk, kv, g, h))
        before = fa.LAUNCHES
        a = tops.flash_attention(q, k, v, causal)
        b2 = fa.flash_attention_cuda(q, k, v, causal)
        want = fa.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 2
        assert torch.equal(a, b2)
        if dt == torch.bfloat16:
            assert bf16_attention_error_ratio(a.float(), want.float()) <= 1.0
        else:
            np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(),
                                       rtol=2e-5, atol=2e-5)
