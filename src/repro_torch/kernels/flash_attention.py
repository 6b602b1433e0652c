"""Flash-attention forward (K3): CUDA kernel and plain version.

`flash_attention_cuda` launches the hand-written Hopper kernel
`csrc/flash_attention.cu`, which replaces the Pallas TPU kernel
`flash_attention_pallas` of `src/repro/kernels/flash_attention.py` together
with its GQA wrapper (`src/repro/kernels/ops.py::flash_attention`): blocked
online softmax, running m, l and acc in float32, `p` rounded to the input
dtype before `p·V`, the causal mask `qpos >= kpos` with both positions from
0.  It takes the JAX package's layouts, q `[B, Sq, Kv, G, H]` and k/v
`[B, Sk, Kv, H]`, reads kv head `kv` in place for every query head
`(kv, g)`, and takes any Sq and Sk (the ragged tail is masked in the
kernel).

Bound on the card: operations, `4·Sq·Sk·H` FLOP per query head (halved
under the causal mask) over 989 TFLOP/s bf16 dense; the bytes (q, k, v, o
once each) over 3.35 TB/s take less time at the LM path's shapes.  The
kernel's source says what its simple design leaves on the table.

`flash_attention_plain` is the plain PyTorch version of the same function:
the full score matrix in float32, the same mask, softmax, `p` cast to the
input dtype before `p·V`.  The CPU tests use it and the chip smoke test
holds the kernel against it; no code path on a CUDA tensor calls it.
`LAUNCHES` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEADS = 65535     # B·Kv·G rides the grid's y dimension

# Kernel launches; reset by callers that count a run.
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain version: q `[B, Sq, Kv, G, H]`, k/v `[B, Sk, Kv, H]` -> o in
    q's layout and dtype."""
    h = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    s = s * (1.0 / math.sqrt(h))
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous, 16-byte aligned CUDA tensors
    q `[B, Sq, Kv, G, H]` and k, v `[B, Sk, Kv, H]`, float32 or bfloat16, H
    in {16, 32, 64, 128}.  Returns o `[B, Sq, Kv, G, H]` in q's dtype.
    bfloat16 runs on the tensor cores (`mma.sync`), float32 on CUDA-core
    FMAs (no TF32).

    Raises on anything else, before any build or launch.
    """
    _check(q.dim() == 5, f"q must be [B, Sq, Kv, G, H], got {tuple(q.shape)}")
    b, sq, kvh, g, h = q.shape
    sk = k.shape[1] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        _check(t.dim() == 4 and t.shape == (b, sk, kvh, h),
               f"{name} must be [B, Sk, Kv, H] = [{b}, Sk, {kvh}, {h}], got "
               f"{tuple(t.shape)}")
    _check(v.shape == k.shape, "k and v must have one shape")
    _check(q.dtype in _DTYPE_CODE,
           f"dtype must be float32 or bfloat16, got {q.dtype}")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    _check(h in HEAD_DIMS, f"head dim must be one of {HEAD_DIMS}, got {h}")
    _check(min(b, sq, sk, kvh, g) > 0, f"empty input {tuple(q.shape)}, Sk={sk}")
    _check(b * kvh * g <= _MAX_HEADS, f"B·Kv·G = {b * kvh * g} > {_MAX_HEADS}")
    _check(max(q.numel(), k.numel()) < 2**31, "more than 2**31 - 1 elements")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
        # the kernel reads 16-byte vectors
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    devices = {q.device, k.device, v.device}
    _check(len(devices) == 1 and q.device.type == "cuda",
           f"needs CUDA tensors on one device, got {sorted(map(str, devices))}"
           " (CPU tensors take flash_attention_plain)")
    out = torch.empty_like(q)
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, sk, kvh, g, h, _DTYPE_CODE[q.dtype], int(causal),
                1.0 / math.sqrt(h), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
