"""The Scatter-Combine ⊕ (paper §4's combine): CUDA kernel and plain version.

`segment_combine_cuda` launches the hand-written Hopper kernel
`csrc/segment_combine.cu`, which replaces the Pallas TPU kernel
`segment_combine_pallas` of `src/repro/kernels/segment_combine.py` on both
of its routes:

  dense route — the every-edge scan over the partition's static dst-sorted
      columns.  The TPU kernel's ingress block table (`build_block_table`)
      collapses to a row pointer, `segment_row_pointer`, built once at
      ingress (`DevicePartition.seg_ptr`);
  tile route  — a gathered frontier tile whose `dst` depends on the data
      (`tile_segment_combine_pallas` + `dynamic_block_table`): a stable
      device sort of the tile's dst, a `searchsorted` row pointer, then the
      same kernel.

Bound on the card: bytes, `E·D·4 + (V+1)·4 + V·D·4` (messages, row
pointer, output; the kernel never reads dst, and E counts only the edges
the row pointer routes to a segment) over 3.35 TB/s.  The tile route's
sort also reads the tile's dst, `E_tile·4` bytes more.  The kernel's source
says what its simple warp-per-segment design leaves on the table.

`segment_combine_plain` is the plain PyTorch version of the same function
(identity-filled output, `scatter_reduce_` with `include_self=True`).  The
CPU tests use it, and the chip smoke test holds the kernel against it; no
code path on a CUDA tensor calls it.  Launch counts are kept per route in
`LAUNCHES`, so a run can show that its combines went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

IDENTITY = {"sum": 0.0, "min": math.inf, "max": -math.inf}
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}
_OP_CODE = {"sum": 0, "min": 1, "max": 2}

# Kernel launches per route; reset by callers that count a run.
LAUNCHES = {"dense": 0, "tile": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def segment_row_pointer(dst_sorted: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """`seg_ptr[v] = searchsorted(dst, v)` for v in [0, num_segments]: the
    edge range of segment v is `[seg_ptr[v], seg_ptr[v+1])`, and entries
    with dst >= num_segments lie past `seg_ptr[num_segments]`.  int32."""
    bounds = torch.arange(num_segments + 1, dtype=dst_sorted.dtype,
                          device=dst_sorted.device)
    return torch.searchsorted(dst_sorted, bounds, out_int32=True)


def segment_combine_plain(msgs: torch.Tensor, dst: torch.Tensor,
                          num_segments: int, op: str) -> torch.Tensor:
    """Plain version: `out[v] = ⊕ msgs[dst == v]`, identity where empty.

    Entries with `dst >= num_segments` are dropped (they scatter into one
    extra row that is cut off).  Works on `msgs [E]` or `[E, D]` and on
    unsorted `dst`.
    """
    out = torch.full((num_segments + 1,) + tuple(msgs.shape[1:]),
                     IDENTITY[op], dtype=msgs.dtype, device=msgs.device)
    idx = dst.clamp(max=num_segments).to(torch.int64)
    idx = idx.view((-1,) + (1,) * (msgs.dim() - 1)).expand_as(msgs)
    out.scatter_reduce_(0, idx, msgs, reduce=_REDUCE[op], include_self=True)
    return out[:num_segments]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"segment_combine_cuda: {msg}")


def segment_combine_cuda(msgs: torch.Tensor, dst: torch.Tensor,
                         seg_ptr: torch.Tensor, num_segments: int, op: str,
                         route: str = "dense") -> torch.Tensor:
    """Launch the CUDA kernel: `msgs [E, D]` float32 contiguous, `dst [E]`
    int32 sorted ascending, `seg_ptr [num_segments + 1]` int32 (see
    `segment_row_pointer`).  Returns `[num_segments, D]` float32.

    Raises on anything else, before any build or launch; `route` names the
    counter in `LAUNCHES` that this launch adds to.
    """
    _check(op in _OP_CODE, f"op must be one of {sorted(_OP_CODE)}, got {op!r}")
    _check(route in LAUNCHES, f"unknown route {route!r}")
    _check(msgs.dtype == torch.float32,
           f"msgs must be float32, got {msgs.dtype}")
    _check(msgs.dim() == 2, f"msgs must be [E, D], got {tuple(msgs.shape)}")
    _check(msgs.is_contiguous(), "msgs must be contiguous")
    _check(dst.dtype == torch.int32, f"dst must be int32, got {dst.dtype}")
    _check(dst.dim() == 1 and dst.shape[0] == msgs.shape[0],
           f"dst must be [E] with E = {msgs.shape[0]}, got {tuple(dst.shape)}")
    _check(0 <= num_segments < 2**31, f"bad num_segments {num_segments}")
    _check(msgs.shape[0] < 2**31, "more than 2**31 - 1 edges")
    _check(seg_ptr.dtype == torch.int32,
           f"seg_ptr must be int32, got {seg_ptr.dtype}")
    _check(seg_ptr.dim() == 1 and seg_ptr.shape[0] == num_segments + 1,
           f"seg_ptr must be [num_segments + 1] = [{num_segments + 1}], "
           f"got {tuple(seg_ptr.shape)}")
    _check(seg_ptr.is_contiguous(), "seg_ptr must be contiguous")
    devices = {msgs.device, dst.device, seg_ptr.device}
    _check(len(devices) == 1 and msgs.device.type == "cuda",
           f"needs CUDA tensors on one device, got {sorted(map(str, devices))}"
           " (CPU tensors take segment_combine_plain)")
    d = msgs.shape[1]
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=msgs.device)
    if num_segments == 0 or d == 0:
        return out
    fn = _build.load("segment_combine").segment_combine_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(msgs.device):
        stream = torch.cuda.current_stream(msgs.device).cuda_stream
        rc = fn(msgs.data_ptr(), seg_ptr.data_ptr(), out.data_ptr(),
                num_segments, d, _OP_CODE[op], stream)
    if rc != 0:
        raise RuntimeError(f"segment_combine kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES[route] += 1
    return out


def sort_tile(msgs: torch.Tensor, dst: torch.Tensor):
    """Stable sort of a tile by destination (the order of every sum within
    a segment is then fixed by the tile).  Sentinel lanes (`dst >=
    num_segments`) sort to the tail."""
    dst_sorted, order = torch.sort(dst, stable=True)
    return msgs.index_select(0, order), dst_sorted


def tile_segment_combine_plain(msgs: torch.Tensor, dst: torch.Tensor,
                               num_segments: int, op: str) -> torch.Tensor:
    """Plain version of the tile route: the same sort, then the plain ⊕."""
    msgs, dst = sort_tile(msgs, dst)
    return segment_combine_plain(msgs, dst, num_segments, op)


def tile_segment_combine_cuda(msgs: torch.Tensor, dst: torch.Tensor,
                              num_segments: int, op: str) -> torch.Tensor:
    """The tile route on the card: sort, row pointer, kernel."""
    msgs, dst = sort_tile(msgs, dst)
    seg_ptr = segment_row_pointer(dst, num_segments)
    return segment_combine_cuda(msgs, dst, seg_ptr, num_segments, op,
                                route="tile")
