"""The dense scan's messages (paper §4's scatter over every edge): a CUDA
kernel and its plain version.

`gather_messages_cuda` launches `csrc/gather_messages.cu`, one pass over
the partition's dst-sorted edge columns that writes each edge's message,
the input of the combine kernel's dense route:

  dense frontier  `msg[e] = form(x[src[e]], prop[e])`;
  otherwise       `form(...)` where `active[src[e]] & edge_mask[e]`, else
                  the ⊕'s identity.

`form` is the program's message (`VertexProgram.message`): "copy" (x),
"add_prop" (x + prop, one float32 add) or "add_one" (x + 1).  It replaces
no TPU kernel: the JAX package forms these messages with `jnp.take` and
elementwise operations that XLA fuses; on the card the same operations
ran as separate PyTorch passes over the edges.  The kernel takes a
`SourceRanking` of the source slots (`rank_sources`, built once a
partition, `DevicePartition.source_ranking`): it first copies the values
(and activity flags) of the slots the edges read into a table in order of
how many edges read them, and the edges read from that, the hubs' rows
packed together (the source says why that is the lever).  Bound on the card: bytes, `message_bytes(e, v, form,
activity)` over 3.35 TB/s.

`gather_messages_plain` is those PyTorch passes, bitwise what the engine's
dense route computed before the kernel, and `gather_messages` dispatches
by device: a CUDA tensor launches the kernel or raises, a CPU tensor takes
the plain version (which reads no ranking), a fake tensor (the dry run)
makes the output and charges the kernel's bytes.  `LAUNCHES` counts the
card's launches a form.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build

FORMS = ("copy", "add_prop", "add_one")
_FORM_CODE = {f: i for i, f in enumerate(FORMS)}

# Kernel launches per form; reset by callers that count a run.
LAUNCHES = {f: 0 for f in FORMS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class SourceRanking:
    """The slots an edge column reads, ranked by how many of its edges read
    them (ties by slot): `order [n]` int32 holds the slot of each rank, and
    `rank_of_src [E]` int32 the rank of each edge's source, so that
    `x[order][rank_of_src] == x[src]`.  `src` is the column it ranks."""

    src: torch.Tensor
    order: torch.Tensor
    rank_of_src: torch.Tensor


def rank_sources(src: torch.Tensor, num_slots: int) -> SourceRanking:
    """Rank the slots of `[0, num_slots)` that `src` (int32) reads, on its
    device: one count, one stable sort of the slots, one gather."""
    counts = torch.bincount(src, minlength=num_slots)
    order = torch.argsort(counts, descending=True, stable=True)
    n = int((counts > 0).sum())
    rank = torch.empty(num_slots, dtype=torch.int32, device=src.device)
    rank[order] = torch.arange(num_slots, dtype=torch.int32,
                               device=src.device)
    return SourceRanking(src, order[:n].to(torch.int32),
                         rank.index_select(0, src))


def reads_ranking(x: torch.Tensor) -> bool:
    """Whether `gather_messages` on `x` takes a `SourceRanking`: on the
    card, and not in the dry run."""
    return x.is_cuda and not isinstance(x, FakeTensor)


def message_bytes(e: int, v: int, form: str, activity: bool) -> int:
    """The least bytes of one pass: `e` edges' src ids and messages (and
    props, and mask bytes where read) streamed once, the `v`-slot value
    table (and its activity bytes) read once."""
    per_edge = 8 + (4 if form == "add_prop" else 0) + (1 if activity else 0)
    return e * per_edge + v * (5 if activity else 4)


def form_messages(form: str, x: torch.Tensor,
                  prop: Optional[torch.Tensor]) -> torch.Tensor:
    """`form` applied to gathered values `x` (`[E]`, or `[E, D]` with the
    edge property broadcast over the lanes)."""
    if form == "copy":
        return x
    if form == "add_prop":
        return x + prop.reshape(prop.shape + (1,) * (x.dim() - prop.dim()))
    if form == "add_one":
        return x + 1.0
    raise ValueError(f"form must be one of {FORMS}, got {form!r}")


def gather_messages_plain(x: torch.Tensor, src: torch.Tensor, form: str,
                          prop: Optional[torch.Tensor] = None,
                          active: Optional[torch.Tensor] = None,
                          edge_mask: Optional[torch.Tensor] = None,
                          identity: float = 0.0) -> torch.Tensor:
    """Plain version: gather, form, and (with `active`) mask and select."""
    msgs = form_messages(form, x.index_select(0, src), prop)
    if active is None:
        return msgs
    live = active.index_select(0, src) & edge_mask
    return torch.where(live, msgs, identity)


def _problem(x, src, form, prop, active, edge_mask, ranking):
    """What `gather_messages_cuda` refuses in its inputs, or None."""
    if form not in _FORM_CODE:
        return f"form must be one of {FORMS}, got {form!r}"
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        return (f"x must be contiguous [slots] float32, got {x.dtype} "
                f"{tuple(x.shape)}")
    if src.dtype != torch.int32 or src.dim() != 1 or not src.is_contiguous():
        return (f"src must be contiguous [E] int32, got {src.dtype} "
                f"{tuple(src.shape)}")
    e = src.shape[0]
    tensors = [x, src]
    if form == "add_prop":
        if (prop is None or prop.dtype != torch.float32
                or tuple(prop.shape) != (e,) or not prop.is_contiguous()):
            return f"add_prop needs a contiguous [{e}] float32 prop"
        tensors.append(prop)
    if (active is None) != (edge_mask is None):
        return "active and edge_mask go together"
    if active is not None:
        if (active.dtype != torch.bool or active.shape != x.shape
                or not active.is_contiguous()):
            return f"active must be contiguous [{x.shape[0]}] bool"
        if (edge_mask.dtype != torch.bool or tuple(edge_mask.shape) != (e,)
                or not edge_mask.is_contiguous()):
            return f"edge_mask must be contiguous [{e}] bool"
        tensors += [active, edge_mask]
    if ranking is None:
        return "needs the ranking of src (rank_sources)"
    if ranking.src is not src:
        return "the ranking was built from another src column"
    tensors += [ranking.order, ranking.rank_of_src]
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        devices = sorted({str(t.device) for t in tensors})
        return (f"needs CUDA tensors on one device, got {devices} (CPU "
                "tensors take gather_messages_plain)")
    return None


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built library with its launcher typed (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = _build.load("gather_messages")
        p = ctypes.c_void_p
        fn = lib.gather_messages_launch
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, p, p, p, p, p, ll, ctypes.c_int,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gather_messages_cuda(x: torch.Tensor, src: torch.Tensor, form: str,
                         prop: Optional[torch.Tensor] = None,
                         active: Optional[torch.Tensor] = None,
                         edge_mask: Optional[torch.Tensor] = None,
                         identity: float = 0.0,
                         ranking: Optional[SourceRanking] = None
                         ) -> torch.Tensor:
    """Launch the kernel: `x [slots]` float32, `src [E]` int32, `prop [E]`
    float32 for "add_prop", `active [slots]` and `edge_mask [E]` bool
    together or not at all, all contiguous on one card, and `ranking` =
    `rank_sources(src, slots)`.  Returns the `[E]` float32 messages.
    Raises on anything else, before any build or launch."""
    problem = _problem(x, src, form, prop, active, edge_mask, ranking)
    if problem:
        raise ValueError(f"gather_messages_cuda: {problem}")
    e = src.shape[0]
    dev = x.device
    msgs = torch.empty(e, dtype=torch.float32, device=dev)
    if e == 0:
        return msgs
    rows = ranking.order.shape[0]
    # the ranked table: 8-byte rows with activity, 4 without
    table = torch.empty(rows * (2 if active is not None else 1),
                        dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.gather_messages_launch(
            ranking.rank_of_src.data_ptr(), x.data_ptr(),
            ranking.order.data_ptr(), rows, table.data_ptr(),
            _ptr(prop) if form == "add_prop" else None, _ptr(active),
            _ptr(edge_mask), msgs.data_ptr(), e, _FORM_CODE[form],
            float(identity), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_messages kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES[form] += 1
    return msgs


def gather_messages(x: torch.Tensor, src: torch.Tensor, form: str,
                    prop: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None,
                    edge_mask: Optional[torch.Tensor] = None,
                    identity: float = 0.0,
                    ranking: Optional[SourceRanking] = None) -> torch.Tensor:
    """The messages of every edge on `x`'s device (see the module)."""
    if isinstance(x, FakeTensor):
        from repro_torch.launch import roofline
        roofline.charge_kernel("gather_messages", 0.0, message_bytes(
            src.shape[0], x.shape[0], form, active is not None))
        return torch.empty(src.shape[0], dtype=torch.float32,
                           device=x.device)
    if not x.is_cuda:
        return gather_messages_plain(x, src, form, prop, active, edge_mask,
                                     identity)
    return gather_messages_cuda(x, src, form, prop, active, edge_mask,
                                identity, ranking)
