"""Flash attention (K3), forward and backward: CUDA kernels and plain
versions.

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

With `return_lse=True` the forward also returns each query row's
statistic `lse = m + log l` of the scaled scores, float32 `[B, Kv, G, Sq]`:
the residual the backward needs beside o, in place of the JAX backward's
saved (m, l).  Serving asks for none and writes none.

`flash_attention_bwd_cuda` launches the backward of `csrc/
flash_attention_bwd.cu`, which replaces `_flash_bwd_rule` of
`src/repro/nn/attention.py` (the JAX package's hand-written backward of
`flash_attention_jax`): from (q, k, v, o, lse, dO) it returns (dQ, dK, dV)
with dK and dV summed over the G query heads of a kv head, in two
deterministic passes and a δ pre-pass; in bf16 both passes run their
products on `wgmma` fed by TMA, with p and dS in registers (the source
says how, its bound and what it leaves on the table).  Both sources
include `csrc/hopper.cuh`, the TMA, mbarrier and `wgmma` building blocks
they share.

`flash_attention_plain` and `flash_attention_bwd_plain` are the plain
PyTorch versions of the same functions: the full score matrix in float32,
the same mask, softmax (`p` cast to the input dtype before `p·V` in the
forward), the same backward formulas in float32 (p and dS cast to the input
dtype before the products that take them, as JAX casts them).  The CPU tests
use them and the chip smoke test holds the kernels against them; no code
path on a CUDA tensor calls them.  `LAUNCHES` counts the forward kernel's
launches, `LAUNCHES_BWD` the backward's (one a call of its wrapper, which
launches its three kernels).
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEADS = 65535     # B·Kv·G rides the grid's y dimension

# Kernel launches; reset by callers that count a run.
LAUNCHES = 0
LAUNCHES_BWD = 0


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_BWD
    LAUNCHES = 0
    LAUNCHES_BWD = 0


def _visible(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    """`[Sq, Sk]` bool: key `j` is visible to query `i` (`i >= j`, both
    from 0, under the causal mask)."""
    if not causal:
        return torch.ones((sq, sk), dtype=torch.bool, device=device)
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled, masked float32 scores `[B, Kv, G, Sq, Sk]`."""
    s = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    return torch.where(_visible(q.shape[1], k.shape[1], causal, q.device), s,
                       NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, return_lse: bool = False):
    """Plain version: q `[B, Sq, Kv, G, H]`, k/v `[B, Sk, Kv, H]` -> o in
    q's layout and dtype (and, with `return_lse`, the float32 row
    statistic `[B, Kv, G, Sq]`)."""
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, dout, causal: bool = True):
    """Plain backward: (dQ, dK, dV) in the inputs' layouts and dtypes from
    the forward's inputs, its output o, its row statistic `lse` and the
    output's gradient `dout`, every product in float32 on the full score
    matrix (the formulas of `_flash_bwd_rule`).  p is rounded to the input
    dtype before dV and dS before dK and dQ, where `_flash_bwd_rule` casts
    them (`p.astype(q.dtype)`, `ds.astype(q.dtype)`): the identity in
    float32, and in bfloat16 the operands the kernel's tensor cores
    take."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    visible = _visible(q.shape[1], k.shape[1], causal, q.device)
    p = torch.where(visible, torch.exp(_scores(q, k, causal)
                                       - lse[..., None]), 0.0)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    delta = torch.einsum("bqkgh,bqkgh->bkgq", dof, o.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    p = p.to(q.dtype).float()
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


_LAUNCH = {}


def _launcher(name: str, pointers: int):
    """The C launcher `<name>_launch` of `csrc/<name>.cu`, built and typed
    at first use: `pointers` pointers, then the ints, the scale and the
    stream."""
    fn = _LAUNCH.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH[name] = fn
    return fn


def _call(fn, dev: torch.device, args, what: str) -> None:
    """Call a launcher on `dev`'s current stream; raise on its error."""
    args = args + (torch.cuda.current_stream(dev).cuda_stream,)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, return_lse: bool = False):
    """Launch the CUDA kernel on contiguous, 16-byte aligned CUDA tensors
    q `[B, Sq, Kv, G, H]` and k, v `[B, Sk, Kv, H]`, float32 or bfloat16, H
    in {16, 32, 64, 128}.  Returns o `[B, Sq, Kv, G, H]` in q's dtype and,
    with `return_lse`, the float32 row statistic `[B, Kv, G, Sq]`.
    bfloat16 runs on the tensor cores (`wgmma` fed by TMA), float32 on
    CUDA-core FMAs (no TF32).

    Raises on anything else, before any build or launch.  On fake tensors
    (the dry run) nothing launches: the outputs are made and the call is
    charged the kernel's counts (`launch.roofline.attention_counts`).
    """
    if isinstance(q, FakeTensor):
        return _fake_forward(q, k, causal, return_lse)
    why = _refusal(q, k, v)
    if why is not None:
        raise ValueError(f"flash_attention_cuda: {why}")
    b, sq, kvh, g, h = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((b, kvh, g, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if lse is None else lse.data_ptr(), b, sq, k.shape[1], kvh, g,
            h, _DTYPE_CODE[q.dtype], int(causal), 1.0 / math.sqrt(h))
    _call(_launcher("flash_attention", 5), q.device, args, "flash_attention")
    global LAUNCHES
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def _fake_forward(q, k, causal, return_lse):
    from repro_torch.launch import roofline
    b, sq, kvh, g, h = q.shape
    roofline.charge_kernel("flash_attention", *roofline.attention_counts(
        b, sq, k.shape[1], kvh, g, h, causal, q.dtype), q.dtype)
    out = torch.empty_like(q)
    if not return_lse:
        return out
    return out, torch.empty((b, kvh, g, sq), dtype=torch.float32,
                            device=q.device)


def _bwd_refusal(q, k, v, o, lse, dout):
    """The first reason the backward refuses these inputs, or None: its
    own operands first, then what the forward refuses."""
    for name, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            return (f"{name} must match q's shape and dtype "
                    f"{tuple(q.shape)} {q.dtype}, got {tuple(t.shape)} "
                    f"{t.dtype}")
        if not t.is_contiguous():
            return f"{name} must be contiguous"
        if t.device != q.device:
            return f"{name} lies on {t.device}, q on {q.device}"
    if q.dim() != 5:
        return f"q must be [B, Sq, Kv, G, H], got {tuple(q.shape)}"
    b, sq, kvh, g, _ = q.shape
    if lse.shape != (b, kvh, g, sq) or lse.dtype != torch.float32:
        return (f"lse must be float32 [B, Kv, G, Sq] = [{b}, {kvh}, {g}, "
                f"{sq}], got {tuple(lse.shape)} {lse.dtype}")
    if not lse.is_contiguous() or lse.device != q.device:
        return "lse must be contiguous on q's device"
    if dout.data_ptr() % 16:        # the bf16 kernels' TMA maps read it
        return "dout must be 16-byte aligned"
    return _refusal(q, k, v)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True):
    """Launch the backward kernels on the forward's inputs (as
    `flash_attention_cuda` takes them), its output o, its row statistic
    `lse` (float32 `[B, Kv, G, Sq]`, from `return_lse=True`) and the
    output's gradient `dout` (o's shape and dtype), all contiguous on one
    card, q, k, v and dout 16-byte aligned.  Returns (dQ, dK, dV) in
    q's and k's shapes and the input dtype.  bfloat16 runs on the tensor
    cores (`wgmma` fed by TMA, p and dS rounded to bf16 as
    `flash_attention_bwd_plain` rounds them), float32 on CUDA-core FMAs (no
    TF32); no atomics, so two calls give the same bits.

    Raises on anything else, before any build or launch.  On fake tensors
    the outputs and the δ scratch are made and the call is charged the
    kernels' counts (`launch.roofline.attention_bwd_counts`).
    """
    fake = isinstance(q, FakeTensor)
    why = None if fake else _bwd_refusal(q, k, v, o, lse, dout)
    if why is not None:
        raise ValueError(f"flash_attention_bwd_cuda: {why}")
    b, sq, kvh, g, h = q.shape
    delta = torch.empty((b, kvh, g, sq), dtype=torch.float32,
                        device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if fake:
        from repro_torch.launch import roofline
        roofline.charge_kernel(
            "flash_attention_bwd", *roofline.attention_bwd_counts(
                b, sq, k.shape[1], kvh, g, h, causal, q.dtype), q.dtype)
        return dq, dk, dv
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], kvh, g, h,
            _DTYPE_CODE[q.dtype], int(causal), 1.0 / math.sqrt(h))
    _call(_launcher("flash_attention_bwd", 10), q.device, args,
          "flash_attention_bwd")
    global LAUNCHES_BWD
    LAUNCHES_BWD += 1
    return dq, dk, dv
