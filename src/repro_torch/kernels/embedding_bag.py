"""EmbeddingBag: the CUDA kernels and their plain versions.

`embedding_bag_forward_cuda` and `embedding_bag_backward_cuda` launch the
hand-written Hopper kernels of `csrc/embedding_bag.cu`, which replace the
JAX package's `embedding_bag` (`src/repro/kernels/ops.py:64`: an XLA
gather, a per-id weight, then the Pallas segment combine for the bag sum):

  forward  — `out[b] = Σ_{bag_ids[i] = b} w[i] · table[ids[i]]` in one
      fused walk: each table row is read by id, weighted and summed into
      its bag, with no `[n, d]` intermediate and no row pointer (the
      kernel finds bag bounds from the sorted `bag_ids`); a second small
      kernel folds the bags that cross shares, in a fixed order;
  backward — one memset of the table gradient, a stable device sort of
      the ids, then one walk of the sorted positions: each run of equal
      ids writes its gradient row once, and each position's weight
      gradient is a dot product with the run's table row.

The source says how the work is balanced.  Bound on the card: bytes.
Forward `n·(4 or 8) + 8·n` (ids, bag ids, weights) plus each distinct row
read once and the `[num_bags, d]` output written once, over 3.35 TB/s;
the backward adds the cotangent, the whole table gradient and the weight
gradient.  Neither kernel takes a float atomic, so two launches give the
same bits.

`embedding_bag_forward_plain` and `embedding_bag_backward_plain` are the
same functions in plain PyTorch: the CPU tests use them and the chip smoke
test holds the kernels against them; no code path on a CUDA tensor calls
them.  Launch counts are kept in `LAUNCHES`, so a run can show that its
bag sums went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels.segment_combine import (rows_at,
                                                 segment_combine_plain)

_I32_MAX = 2**31 - 1
_TILE = 128                 # columns a unit covers; wider tables take tiles

# Kernel launches by direction; reset by callers that count a run.
LAUNCHES = {"forward": 0, "backward": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def embedding_bag_forward_plain(table: torch.Tensor, ids: torch.Tensor,
                                bag_ids: torch.Tensor, num_bags: int,
                                weights: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain version: gather, weight, then the plain ⊕ = sum by bag;
    `bag_ids >= num_bags` are dropped, empty bags are zero rows."""
    rows = table.index_select(0, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    return segment_combine_plain(rows, bag_ids, num_bags, "sum")


def embedding_bag_backward_plain(grad: torch.Tensor, table: torch.Tensor,
                                 ids: torch.Tensor, bag_ids: torch.Tensor,
                                 num_bags: int,
                                 weights: Optional[torch.Tensor] = None,
                                 need_table: bool = True,
                                 need_weights: bool = True):
    """Plain version of the gradients for `grad [num_bags, d]`:
    `(grad_table, grad_weights)`, each None where not asked for.  The table
    gradient sums `w[i] · grad[bag_ids[i]]` into row `ids[i]`; the weight
    gradient is `<grad[bag_ids[i]], table[ids[i]]>`."""
    rows = rows_at(grad, bag_ids, num_bags, 0.0)
    g_table = g_w = None
    if need_table:
        msgs = rows * weights[:, None] if weights is not None else rows
        g_table = segment_combine_plain(msgs, ids, table.shape[0], "sum")
    if need_weights:
        g_w = (rows * table.index_select(0, ids)).sum(1)
    return g_table, g_w


def _problem(table, ids, bag_ids, num_bags, weights, grad=None):
    """What the CUDA wrappers refuse in their inputs, or None.  Plain tests
    first, so a valid launch formats no message."""
    if table.dtype != torch.float32:
        return f"table must be float32, got {table.dtype}"
    if table.dim() != 2:
        return f"table must be [N, d], got {tuple(table.shape)}"
    if not table.is_contiguous():
        return "table must be contiguous"
    if table.shape[0] > _I32_MAX:
        return f"more than 2**31 - 1 table rows: {table.shape[0]}"
    if ids.dtype not in (torch.int32, torch.int64):
        return f"ids must be int32 or int64, got {ids.dtype}"
    if ids.dim() != 1 or not ids.is_contiguous():
        return f"ids must be a contiguous [n], got {tuple(ids.shape)}"
    n = ids.shape[0]
    if bag_ids.dtype != torch.int32:
        return f"bag_ids must be int32, got {bag_ids.dtype}"
    if bag_ids.dim() != 1 or bag_ids.shape[0] != n:
        return (f"bag_ids must be [n] with n = {n}, got "
                f"{tuple(bag_ids.shape)}")
    if not bag_ids.is_contiguous():
        return "bag_ids must be contiguous"
    if not 0 <= num_bags <= _I32_MAX:
        return f"num_bags must be in [0, 2**31 - 1], got {num_bags}"
    tensors = [table, ids, bag_ids]
    if weights is not None:
        if weights.dtype != torch.float32:
            return f"weights must be float32, got {weights.dtype}"
        if weights.dim() != 1 or weights.shape[0] != n:
            return (f"weights must be [n] with n = {n}, got "
                    f"{tuple(weights.shape)}")
        if not weights.is_contiguous():
            return "weights must be contiguous"
        tensors.append(weights)
    if grad is not None:
        want = (num_bags, table.shape[1])
        if grad.dtype != torch.float32 or tuple(grad.shape) != want:
            return (f"grad must be float32 {list(want)}, got {grad.dtype} "
                    f"{list(grad.shape)}")
        if not grad.is_contiguous():
            return "grad must be contiguous"
        tensors.append(grad)
    dev = table.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        devices = sorted({str(t.device) for t in tensors})
        return (f"needs CUDA tensors on one device, got {devices} (CPU "
                "tensors take the plain versions)")
    return None


_LIB: Optional[ctypes.CDLL] = None


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A build of `csrc/embedding_bag.cu` with its launchers typed."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args, res in (
            ("embedding_bag_units", [ll, i], ll),
            ("embedding_bag_zero_launch", [p, ll, p], i),
            ("embedding_bag_forward_launch",
             [p, ll, i, p, i, p, p, ll, i, p, p, p, p], i),
            ("embedding_bag_backward_launch",
             [p, ll, i, p, i, p, p, p, p, ll, i, p, p, p, p, p, p], i)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def _lib() -> ctypes.CDLL:
    """The built library, typed (built at first use)."""
    global _LIB
    if _LIB is None:
        _LIB = _typed(_build.load("embedding_bag"))
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _carries(units: int, d: int, device) -> tuple:
    """One scratch buffer: carry_val [units, d] float32 (first, so it is
    16-byte aligned), then carry_row [units] int32.  The wrappers drop it
    when they return: the allocator hands it out again only in the
    stream's order, after the launch."""
    scratch = torch.empty(units * (d + 1), dtype=torch.float32,
                          device=device)
    return scratch.data_ptr(), scratch.data_ptr() + 4 * units * d, scratch


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"embedding_bag {what} kernel launch failed: "
                           f"cudaError {rc}")


def embedding_bag_forward_cuda(table: torch.Tensor, ids: torch.Tensor,
                               bag_ids: torch.Tensor, num_bags: int,
                               weights: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """The forward kernel: `table [N, d]` float32, `ids [n]` int32 or int64
    in [0, N) (the kernel traps on any other), `bag_ids [n]` int32 sorted
    ascending, `weights [n]` float32 or None; all contiguous on one card.
    Returns `[num_bags, d]` float32.  Raises on anything else, before any
    build or launch."""
    d = table.shape[1]
    if isinstance(table, FakeTensor):   # the dry run: its bound's bytes
        from repro_torch.launch import roofline
        n = ids.shape[0]
        roofline.charge_kernel("embedding_bag", 0.0, roofline.emb_bytes(
            n, min(n, table.shape[0]), d, num_bags, ids.element_size(),
            weights is not None))
        return torch.empty((num_bags, d), dtype=torch.float32,
                           device=table.device)
    problem = _problem(table, ids, bag_ids, num_bags, weights)
    if problem:
        raise ValueError(f"embedding_bag_forward_cuda: {problem}")
    if num_bags == 0 or d == 0:
        return torch.zeros((num_bags, d), dtype=torch.float32,
                           device=table.device)
    lib = _lib()
    out = torch.empty((num_bags, d), dtype=torch.float32,
                      device=table.device)
    units = lib.embedding_bag_units(num_bags + ids.shape[0], d)
    carry_val, carry_row, scratch = _carries(units, d, table.device)
    with torch.cuda.device(table.device):
        rc = lib.embedding_bag_forward_launch(
            table.data_ptr(), table.shape[0], d, ids.data_ptr(),
            int(ids.dtype == torch.int64), _ptr(weights), bag_ids.data_ptr(),
            ids.shape[0], num_bags, out.data_ptr(), carry_row, carry_val,
            torch.cuda.current_stream(table.device).cuda_stream)
    _raise_on(rc, "forward")
    LAUNCHES["forward"] += 1
    return out


def embedding_bag_backward_cuda(grad: torch.Tensor, table: torch.Tensor,
                                ids: torch.Tensor, bag_ids: torch.Tensor,
                                num_bags: int,
                                weights: Optional[torch.Tensor] = None,
                                need_table: bool = True,
                                need_weights: bool = True):
    """The backward kernel for `grad [num_bags, d]` float32 at the forward's
    inputs: `(grad_table [N, d], grad_weights [n])` float32, each None where
    not asked for (`need_weights` needs `weights`).  The table gradient
    walks the stable ids-sorted order (`torch.sort`, run here only when it
    is asked for).  Raises on bad input before any build or launch."""
    problem = ("need_weights without weights"
               if need_weights and weights is None else None
               if isinstance(table, FakeTensor) else
               _problem(table, ids, bag_ids, num_bags, weights, grad))
    if problem:
        raise ValueError(f"embedding_bag_backward_cuda: {problem}")
    dev = table.device
    n, d = ids.shape[0], table.shape[1]
    g_table = (torch.empty(table.shape, dtype=torch.float32, device=dev)
               if need_table else None)
    g_w = (torch.empty(n, dtype=torch.float32, device=dev)
           if need_weights else None)
    if not (need_table or need_weights):
        return g_table, g_w
    if isinstance(table, FakeTensor):   # the dry run: the table gradient
        from repro_torch.launch import roofline
        roofline.charge_kernel("embedding_bag_bwd", 0.0, roofline.emb_bytes(
            n, min(n, table.shape[0]), d, num_bags, ids.element_size(),
            weights is not None) + (table.numel() * 4 if need_table else 0))
        return g_table, g_w
    if n == 0 or d == 0:
        return (None if g_table is None else g_table.zero_(),
                None if g_w is None else g_w.zero_())
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if need_table:
        with torch.cuda.device(dev):
            _raise_on(lib.embedding_bag_zero_launch(
                g_table.data_ptr(), g_table.numel() * 4, stream), "memset")
        sorted_ids, order = torch.sort(ids, stable=True)
    else:
        sorted_ids, order = ids, None
    units = lib.embedding_bag_units(n, d)
    carry_val = carry_row = scratch = dot_part = None
    if need_table:
        carry_val, carry_row, scratch = _carries(units, d, dev)
    tiles = (d + _TILE - 1) // _TILE
    if need_weights and tiles > 1:
        dot_part = torch.empty((tiles, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.embedding_bag_backward_launch(
            table.data_ptr(), table.shape[0], d, sorted_ids.data_ptr(),
            int(ids.dtype == torch.int64), _ptr(order), _ptr(weights),
            bag_ids.data_ptr(), grad.data_ptr(), n, num_bags, _ptr(g_table),
            _ptr(g_w), _ptr(dot_part), carry_row, carry_val, stream)
    _raise_on(rc, "backward")
    LAUNCHES["backward"] += 1
    return g_table, g_w
