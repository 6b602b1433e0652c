"""The Scatter-Combine ⊕ (paper §4's combine): CUDA kernels and plain versions.

`segment_combine_cuda` launches the hand-written Hopper kernel
`csrc/segment_combine.cu`, which replaces the Pallas TPU kernel
`segment_combine_pallas` of `src/repro/kernels/segment_combine.py` on both
of its routes:

  dense route — the every-edge scan over the partition's static dst-sorted
      columns.  The TPU kernel's ingress block table (`build_block_table`)
      collapses to a row pointer, `segment_row_pointer`, built once at
      ingress (`DevicePartition.seg_ptr`);
  tile route  — a gathered frontier tile whose `dst` depends on the data
      (`tile_segment_combine_pallas` + `dynamic_block_table`): the
      order-preserving compaction of the lanes routed to a segment
      (`compact_lanes_cuda`, a kernel of the same source), a stable device
      sort of only those lanes, a `searchsorted` row pointer, then the same
      combine kernel.

The combine kernel balances the merge path of row ends and edges across
its units (the source says how), so hubs and runs of empty segments cost
what their edges and rows do.  Bound on the card: bytes, `E·D·4 + (V+1)·4 +
V·D·4` (messages, row pointer, output; the kernel never reads dst, and E
counts only the edges the row pointer routes to a segment) over
3.35 TB/s.  The compaction reads every lane's dst once, `N·4` bytes, and
writes 8 bytes per valid lane.

`segment_combine_plain` and `compact_lanes_plain` are the plain PyTorch
versions of the same functions.  The CPU tests use them, and the chip
smoke test holds the kernels against them; no code path on a CUDA tensor
calls them.  Launch counts are kept in `LAUNCHES`, per route for the
combine kernel and under "compact" for the compaction, so a run can show
that its combines went through the kernels.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

IDENTITY = {"sum": 0.0, "min": math.inf, "max": -math.inf}
_REDUCE = {"sum": "sum", "min": "amin", "max": "amax"}
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_I32_MAX = 2**31 - 1
# The most lanes a tile may hold: the kernels index lanes with int32.
MAX_LANES = _I32_MAX

# Kernel launches per route; reset by callers that count a run.
LAUNCHES = {"dense": 0, "tile": 0, "compact": 0}
# Host reads of a compaction's valid total (`compact_lanes_cuda` called
# without `valid`); reset with the launches.
HOST_READS = {"compact_total": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    HOST_READS["compact_total"] = 0


def segment_row_pointer(dst_sorted: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """`seg_ptr[v] = searchsorted(dst, v)` for v in [0, num_segments]: the
    edge range of segment v is `[seg_ptr[v], seg_ptr[v+1])`, and entries
    with dst >= num_segments lie past `seg_ptr[num_segments]`.  int32."""
    bounds = torch.arange(num_segments + 1, dtype=dst_sorted.dtype,
                          device=dst_sorted.device)
    return torch.searchsorted(dst_sorted, bounds, out_int32=True)


def rows_at(x: torch.Tensor, dst: torch.Tensor, num_segments: int,
            fill: float) -> torch.Tensor:
    """`x[dst]` over `x`'s segment rows, `fill` where dst >= num_segments
    (a lane the combine dropped): the transpose of the ⊕ = sum."""
    pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    idx = dst.clamp(max=num_segments)
    return torch.cat([x, pad]).index_select(0, idx)


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


def _combine_problem(msgs, dst, seg_ptr, num_segments, op, route):
    """What `segment_combine_cuda` refuses in its inputs, or None.  Plain
    tests first, so a valid launch formats no message."""
    if op not in _OP_CODE:
        return f"op must be one of {sorted(_OP_CODE)}, got {op!r}"
    if route not in ("dense", "tile"):
        return f"unknown route {route!r}"
    if msgs.dtype != torch.float32:
        return f"msgs must be float32, got {msgs.dtype}"
    if msgs.dim() != 2:
        return f"msgs must be [E, D], got {tuple(msgs.shape)}"
    if not msgs.is_contiguous():
        return "msgs must be contiguous"
    if dst.dtype != torch.int32:
        return f"dst must be int32, got {dst.dtype}"
    if dst.dim() != 1 or dst.shape[0] != msgs.shape[0]:
        return (f"dst must be [E] with E = {msgs.shape[0]}, got "
                f"{tuple(dst.shape)}")
    if not 0 <= num_segments <= _I32_MAX - msgs.shape[0]:
        return (f"num_segments + E must be in [0, 2**31 - 1], got "
                f"{num_segments} + {msgs.shape[0]}")
    if seg_ptr.dtype != torch.int32:
        return f"seg_ptr must be int32, got {seg_ptr.dtype}"
    if seg_ptr.dim() != 1 or seg_ptr.shape[0] != num_segments + 1:
        return (f"seg_ptr must be [num_segments + 1] = [{num_segments + 1}], "
                f"got {tuple(seg_ptr.shape)}")
    if not seg_ptr.is_contiguous():
        return "seg_ptr must be contiguous"
    dev = msgs.device
    if dev.type != "cuda" or dst.device != dev or seg_ptr.device != dev:
        devices = sorted({str(dev), str(dst.device), str(seg_ptr.device)})
        return (f"needs CUDA tensors on one device, got {devices} (CPU "
                "tensors take segment_combine_plain)")
    return None


def _compact_problem(dst, num_segments, valid):
    """What `compact_lanes_cuda` refuses in its inputs, or None."""
    if dst.dtype != torch.int32:
        return f"dst must be int32, got {dst.dtype}"
    if dst.dim() != 1:
        return f"dst must be [N], got {tuple(dst.shape)}"
    if not dst.is_contiguous():
        return "dst must be contiguous"
    n = dst.shape[0]
    if n > MAX_LANES:
        return "more than 2**31 - 1 lanes"
    if not 0 <= num_segments <= _I32_MAX:
        return f"bad num_segments {num_segments}"
    if valid is not None and not 0 <= valid <= n:
        return f"valid must be in [0, {n}], got {valid}"
    if dst.device.type != "cuda":
        return (f"needs a CUDA tensor, got {dst.device} (CPU tensors take "
                "compact_lanes_plain)")
    return None


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built library with its launchers typed (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("segment_combine")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name, args, res in (
                ("segment_combine_units", [i, ll, i], ll),
                ("segment_combine_launch",
                 [p, p, p, p, p, p, i, i, i, i, p], i),
                ("compact_lanes_counts", [ll], ll),
                ("compact_lanes_count_launch", [p, ll, i, p, p, p, ll, p], i),
                ("compact_lanes_write_launch", [p, ll, i, p, p, p, p, p], i)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _LIB = lib
    return _LIB


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def segment_combine_cuda(msgs: torch.Tensor, dst: torch.Tensor,
                         seg_ptr: torch.Tensor, num_segments: int, op: str,
                         route: str = "dense") -> torch.Tensor:
    """Launch the CUDA kernel: `msgs [E, D]` float32 contiguous, `dst [E]`
    int32 sorted ascending, `seg_ptr [num_segments + 1]` int32 (see
    `segment_row_pointer`).  Returns `[num_segments, D]` float32.

    Raises on anything else, before any build or launch; `route` ("dense"
    or "tile") names the counter in `LAUNCHES` that this launch adds to.
    """
    problem = _combine_problem(msgs, dst, seg_ptr, num_segments, op, route)
    if problem:
        raise ValueError(f"segment_combine_cuda: {problem}")
    e, d = msgs.shape
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=msgs.device)
    if num_segments == 0 or d == 0:
        return out
    lib = _lib()
    units = lib.segment_combine_units(num_segments, e, d)
    # one scratch buffer: row_at [units + 1], carry_row [units] (int32),
    # carry_val [units, d] (float32)
    scratch = torch.empty(units * (d + 2) + 1, dtype=torch.int32,
                          device=msgs.device)
    row_at = scratch.data_ptr()
    carry_row = row_at + 4 * (units + 1)
    carry_val = carry_row + 4 * units
    with torch.cuda.device(msgs.device):
        rc = lib.segment_combine_launch(
            msgs.data_ptr(), seg_ptr.data_ptr(), out.data_ptr(), row_at,
            carry_row, carry_val, units, num_segments, d, _OP_CODE[op],
            _stream(msgs))
    _raise_on(rc, "segment_combine")
    LAUNCHES[route] += 1
    return out


def compact_lanes_plain(dst: torch.Tensor, num_segments: int):
    """Plain version of the compaction: `(dst[keep], keep)` with `keep` the
    lanes whose dst is < num_segments, in lane order (int32)."""
    keep = torch.nonzero(dst < num_segments).squeeze(1)
    return dst.index_select(0, keep), keep.to(torch.int32)


def compact_lanes_cuda(dst: torch.Tensor, num_segments: int,
                       valid: Optional[int] = None):
    """The compaction kernel: `(dst_c [n], lane [n])` int32, the lanes of
    `dst [N]` (int32, contiguous, CUDA) with dst < num_segments, in lane
    order.

    `valid`, when given, is n: the outputs are sized with no host sync, and
    the kernel traps on the card if the lanes it counts differ (a broken
    caller invariant, never a silent wrong answer).  Without it the wrapper
    reads the count back from the card.
    """
    problem = _compact_problem(dst, num_segments, valid)
    if problem:
        raise ValueError(f"compact_lanes_cuda: {problem}")
    n = dst.shape[0]
    dev = dst.device
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty.clone()
    lib = _lib()
    rounds = lib.compact_lanes_counts(n)
    # one scratch buffer: total [1], counts [rounds], offsets [rounds]
    scratch = torch.empty(2 * rounds + 1, dtype=torch.int32, device=dev)
    total = scratch[:1]
    counts = scratch.data_ptr() + 4
    offsets = counts + 4 * rounds
    with torch.cuda.device(dev):
        stream = _stream(dst)
        rc = lib.compact_lanes_count_launch(
            dst.data_ptr(), n, num_segments, counts, offsets,
            total.data_ptr(), -1 if valid is None else valid, stream)
        _raise_on(rc, "compact_lanes count")
        if valid is None:
            kept = int(total.item())
            HOST_READS["compact_total"] += 1
        else:
            kept = valid
        out = torch.empty(2 * kept, dtype=torch.int32, device=dev)
        dst_c, lane = out[:kept], out[kept:]
        rc = lib.compact_lanes_write_launch(
            dst.data_ptr(), n, num_segments, counts, offsets,
            dst_c.data_ptr(), lane.data_ptr(), stream)
        _raise_on(rc, "compact_lanes write")
    LAUNCHES["compact"] += 1
    return dst_c, lane


def sort_valid_lanes(msgs: torch.Tensor, dst_c: torch.Tensor,
                     lane: torch.Tensor):
    """Stable sort of the compacted lanes by destination, with their
    messages gathered from the tile: the sum order within a segment is then
    the tile's lane order."""
    dst_sorted, order = torch.sort(dst_c, stable=True)
    return msgs.index_select(0, lane.index_select(0, order)), dst_sorted


def tile_segment_combine_plain(msgs: torch.Tensor, dst: torch.Tensor,
                               num_segments: int, op: str,
                               valid: Optional[int] = None) -> torch.Tensor:
    """Plain version of the tile route: the plain compaction, the same
    sort, then the plain ⊕.  `valid`, when given, must be the count of
    lanes routed to a segment."""
    dst_c, lane = compact_lanes_plain(dst, num_segments)
    if valid is not None and valid != dst_c.shape[0]:
        raise ValueError(f"tile_segment_combine: valid={valid}, but "
                         f"{dst_c.shape[0]} lanes are routed to a segment")
    msgs, dst_c = sort_valid_lanes(msgs, dst_c, lane)
    return segment_combine_plain(msgs, dst_c, num_segments, op)


def tile_segment_combine_cuda(msgs: torch.Tensor, dst: torch.Tensor,
                              num_segments: int, op: str,
                              valid: Optional[int] = None) -> torch.Tensor:
    """The tile route on the card: compaction, sort of the valid lanes, row
    pointer, kernel."""
    dst_c, lane = compact_lanes_cuda(dst, num_segments, valid)
    msgs, dst_c = sort_valid_lanes(msgs, dst_c, lane)
    seg_ptr = segment_row_pointer(dst_c, num_segments)
    return segment_combine_cuda(msgs, dst_c, seg_ptr, num_segments, op,
                                route="tile")
