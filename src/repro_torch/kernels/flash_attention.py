"""Flash-attention forward (K3): CUDA kernel and plain version.

`flash_attention_cuda` launches the hand-written Hopper kernels of
`csrc/flash_attention.cu`, which replace the Pallas TPU kernel
`flash_attention_pallas` of `src/repro/kernels/flash_attention.py` together
with its GQA wrapper (`src/repro/kernels/ops.py::flash_attention`): blocked
online softmax, running m, l and acc in float32, `p` rounded to the input
dtype before `p·V`, the causal mask `qpos >= kpos` with both positions from
0.  They take the JAX package's layouts, q `[B, Sq, Kv, G, H]` and k/v
`[B, Sk, Kv, H]`, read kv head `kv` in place for every query head
`(kv, g)`, and take any Sq and Sk (the ragged tail is masked in the
kernel).

Bound on the card: operations, `4·Sq·Sk·H` FLOP per query head (halved
under the causal mask) over 989 TFLOP/s bf16 dense; the bytes (q, k, v, o
once each) over 3.35 TB/s take less time at the LM path's shapes.

bfloat16 runs the warp-specialised `wgmma` kernel: one CTA per (batch, kv
head, share of at most 3 of its G query heads, 64 query rows) loads each
K/V tile once for the heads of its share, through TMA into a 2-stage ring
of mbarriers, and one consumer warpgroup per query head runs both products
on `wgmma` (S = Q·Kᵀ from shared memory; P from registers times V).  Its
TMA maps are 5-D over q (H, G, Kv, Sq, B) and 4-D over k/v (H, Kv, Sk, B),
so a batch's ragged tail is zero-filled, not read from the next batch;
they need 16-byte aligned bases, as the wrapper checks.  float32 runs on
CUDA-core FMAs (no TF32).  The source says what each design leaves on the
table.

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


def _refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The first reason the kernel refuses these inputs, or None.  Each
    message is formatted only when its check fails: the wrapper runs once
    a prefill layer, and the LM path is bound by the host."""
    if q.dim() != 5:
        return f"q must be [B, Sq, Kv, G, H], got {tuple(q.shape)}"
    b, sq, kvh, g, h = q.shape
    sk = k.shape[1] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        if t.dim() != 4 or t.shape != (b, sk, kvh, h):
            return (f"{name} must be [B, Sk, Kv, H] = [{b}, Sk, {kvh}, {h}], "
                    f"got {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODE:
        return f"dtype must be float32 or bfloat16, got {q.dtype}"
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}"
    if h not in HEAD_DIMS:
        return f"head dim must be one of {HEAD_DIMS}, got {h}"
    if min(b, sq, sk, kvh, g) <= 0:
        return f"empty input {tuple(q.shape)}, Sk={sk}"
    if b * kvh * g > _MAX_HEADS:
        return f"B·Kv·G = {b * kvh * g} > {_MAX_HEADS}"
    if max(q.numel(), k.numel()) >= 2**31:
        return "more than 2**31 - 1 elements"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        # the f32 kernel reads 16-byte vectors; TMA maps need 16-byte bases
        if t.data_ptr() % 16:
            return f"{name} must be 16-byte aligned"
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        devices = sorted({str(q.device), str(k.device), str(v.device)})
        return (f"needs CUDA tensors on one device, got {devices} (CPU "
                "tensors take flash_attention_plain)")
    return None


_LAUNCH = None


def _launcher():
    """The library's C launcher, built and typed at first use."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = _build.load("flash_attention").flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous, 16-byte aligned CUDA tensors
    q `[B, Sq, Kv, G, H]` and k, v `[B, Sk, Kv, H]`, float32 or bfloat16, H
    in {16, 32, 64, 128}.  Returns o `[B, Sq, Kv, G, H]` in q's dtype.
    bfloat16 runs on the tensor cores (`wgmma` fed by TMA), float32 on
    CUDA-core FMAs (no TF32).

    Raises on anything else, before any build or launch.
    """
    why = _refusal(q, k, v)
    if why is not None:
        raise ValueError(f"flash_attention_cuda: {why}")
    b, sq, kvh, g, h = q.shape
    out = torch.empty_like(q)
    fn = _launcher()
    dev = q.device
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], kvh, g, h, _DTYPE_CODE[q.dtype], int(causal),
            1.0 / math.sqrt(h), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
