"""H100 roofline of one step per device, counted while the step runs on
fake tensors (the counterpart of `repro/launch/roofline.py`, which reads
compiled HLO text).

`StepCounter` is a `TorchDispatchMode`: entered inside a `FakeTensorMode`
(the dry run, `launch/dryrun.py`) it sees every ATen op of the step, at
the shapes a device holds (a DTensor op is counted at its local shards'
shapes: the counter passes it on to DTensor's dispatch, whose local ops
come back to it), and
counts per device:

  FLOPs       — the matmul and attention ops of `torch.utils.flop_counter`
                (2 · |result| · contracted size), by input dtype;
  HBM bytes   — operand + result bytes of every op that moves data (the
                conservative model of JAX's `memory_time_s`): views move
                nothing, `empty` writes nothing, a gather reads and writes
                its result (2 x result + the index), a scatter into a
                buffer its source twice and the index;
  link bytes  — per collective type, JAX's ring rules: all-gather →
                result bytes, all-reduce → 2 x operand bytes,
                reduce-scatter / all-to-all / permute → operand bytes;
  peak        — the high-water mark of live device storage (each storage
                once, rounded up to the caching allocator's 512 bytes;
                the fake tensors' device is "cuda", or "meta" where torch
                has no CUDA, and host tensors do not count).

A hand-written kernel of the port (K1, K2's route, K3 and its backward,
EmbeddingBag) does not run on fake tensors: its wrapper's shape route
(`kernels/*.py`) makes its outputs and calls `charge_kernel` with the
kernel's own work, the counts of `PERF.md`'s bound column (the functions
below, which `chip_smoke.py` prints as `bound_ms`): never the plain
version's step-by-step arithmetic or its `[.., Sq, Sk]` score buffer.

Peaks (NVIDIA H100 SXM, dense): 989 TFLOP/s bf16 (and
fp16), 67 TFLOP/s float32 on the CUDA cores (the port enables no TF32),
3.35 TB/s HBM3, NVLink 4 at 450 GB/s each way between the 8 cards of a
node.  A collective whose group leaves a node of 8 (ranks r // 8 differ)
runs at 50 GB/s a card: one 400 Gb/s ConnectX-7 InfiniBand port per GPU,
as NVIDIA's DGX H100 system (8 such ports for 8 GPUs) provides.  Eager
PyTorch fuses nothing, so the "fused" memory model equals the raw one.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
# H100 SXM dense peaks by input type: bf16 tensor cores, float32 FMA
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_FLOPS_BF16 = PEAK_FLOPS[torch.bfloat16]
NVLINK_BYTES_PER_S = 450e9         # NVLink 4, each way, within a node
INTER_NODE_BYTES_PER_S = 50e9      # one 400 Gb/s InfiniBand port a GPU
DEVICES_PER_NODE = 8
ALLOC_ROUND = 512                  # the caching allocator's block size


# ------------------------------------------------------------ kernel bounds
def combine_bytes(e: int, d: int, v: int) -> int:
    """K1's bytes: `e` routed edges' messages, the row pointer and the
    output, each once (it never reads dst)."""
    return e * d * 4 + (v + 1) * 4 + v * d * 4


def bound_ms(e: int, d: int, v: int) -> float:
    """Least time to move the kernel's bytes: `e` routed edges' messages,
    the row pointer and the output, each once."""
    return combine_bytes(e, d, v) / HBM_BYTES_PER_S * 1e3


def route_bytes(lanes: int, e: int, d: int, v: int) -> int:
    return lanes * 4 + e * d * 4 + v * d * 4


def route_bound_ms(lanes: int, e: int, d: int, v: int) -> float:
    """Least time of the whole tile route: every lane's dst, the `e` routed
    lanes' messages and the output, each once."""
    return route_bytes(lanes, e, d, v) / HBM_BYTES_PER_S * 1e3


def emb_bytes(n, distinct, d, num_bags, id_bytes=4, weighted=True) -> int:
    return (n * (id_bytes + 4 + 4 * weighted) + distinct * d * 4
            + num_bags * d * 4)


def emb_bound_ms(n, distinct, d, num_bags, id_bytes=4, weighted=True):
    """Least time of the forward: ids, bag ids and weights once, each
    distinct table row once, the output once."""
    return emb_bytes(n, distinct, d, num_bags, id_bytes,
                     weighted) / HBM_BYTES_PER_S * 1e3


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs attention computes: query i sees keys 0..i when
    causal."""
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def attention_counts(b, sq, sk, kv, g, h, causal, dtype):
    """(FLOPs, bytes) of the forward: 4·H a visible pair; q, k, v and o
    once each."""
    flops = 4.0 * h * visible_pairs(sq, sk, causal) * b * kv * g
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * sq * kv * g * h + 2 * b * sk * kv * h) * size
    return flops, nbytes


def attention_bwd_counts(b, sq, sk, kv, g, h, causal, dtype):
    """(FLOPs, bytes) of the backward: 5 products of 2·H a visible pair;
    q, k, v, o, dO, lse in and dQ, dK, dV out once each."""
    flops = 10.0 * h * visible_pairs(sq, sk, causal) * b * kv * g
    size = torch.finfo(dtype).bits // 8
    nbytes = ((4 * b * sq * kv * g * h + 4 * b * sk * kv * h) * size
              + 4 * b * kv * g * sq)
    return flops, nbytes


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_bound(b, sq, sk, kv, g, h, causal, dtype):
    """(bound_ms, bound_by): the FLOPs of the visible (query, key) pairs,
    4·H each, over the input type's peak, against the bytes of q, k, v and
    o, each once, over 3.35 TB/s."""
    return _bound(*attention_counts(b, sq, sk, kv, g, h, causal, dtype),
                  dtype)


def attention_bwd_bound(b, sq, sk, kv, g, h, causal, dtype):
    """(bound_ms, bound_by) of the backward: 5 products of 2·H FLOP a
    visible (query, key) pair over the input type's peak, against the
    bytes of q, k, v, o, dO, lse in and dQ, dK, dV out, each once."""
    return _bound(*attention_bwd_counts(b, sq, sk, kv, g, h, causal, dtype),
                  dtype)


# ----------------------------------------------------------------- counting
_ACTIVE: List["StepCounter"] = []


def charge_kernel(name: str, flops: float, nbytes: float,
                  dtype=torch.float32) -> None:
    """Charge a hand-written kernel's call to the active counter (a
    wrapper's shape route calls it; nothing happens outside a count)."""
    if _ACTIVE:
        _ACTIVE[-1].charge(name, flops, nbytes, dtype)


_GATHERS = {"index_select", "gather", "embedding", "index"}
_SCATTERS = {"scatter", "scatter_", "scatter_add", "scatter_add_",
             "scatter_reduce", "scatter_reduce_", "index_put",
             "index_put_", "index_copy", "index_copy_", "index_add",
             "index_add_", "_index_put_impl_", "masked_scatter_"}
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "_local_scalar_dense",
             "device", "dim", "sym_size", "sym_stride", "sym_numel",
             "is_same_size"}
_COLLECTIVES = {"allgather_": "all-gather", "_allgather_base_": "all-gather",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_out": "all-gather",
                "allreduce_": "all-reduce", "all_reduce": "all-reduce",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_tensor": "reduce-scatter",
                "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
                "all_to_all_single": "all-to-all",
                "broadcast_": "collective-permute",
                "send": "collective-permute", "recv_": "collective-permute"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(args) -> Optional[List[int]]:
    """The global ranks of the process group a c10d op names (an object or
    a registered name), or None."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in args:
        pg = None
        if isinstance(a, dist.ProcessGroup):
            pg = a
        elif isinstance(a, torch.ScriptObject):
            pg = dist.ProcessGroup.unbox(a)
        elif isinstance(a, str):
            try:
                pg = c10d._resolve_process_group(a)
            except Exception:   # not a group name
                pg = None
        if pg is not None:
            return dist.get_process_group_ranks(pg)
    return None


@dataclasses.dataclass
class Cost:
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    link_bytes: float = 0.0
    collective_s: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return sum(self.flops_by_dtype.values())


class StepCounter(TorchDispatchMode):
    """Counts a step's work per device (see the module docstring) and its
    live device storage.  `counting` can be turned off for a warm-up pass
    while the storage is still tracked."""

    def __init__(self, devices_per_node: int = DEVICES_PER_NODE):
        super().__init__()
        self.cost = Cost()
        self.counting = True
        self.devices_per_node = devices_per_node
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        self.inferring = 0
        self.warnings: List[str] = []

    def __enter__(self):
        _ACTIVE.append(self)
        self._shape_inference(True)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._shape_inference(False)
        return super().__exit__(*exc)

    def _shape_inference(self, on: bool) -> None:
        """While counting, DTensor's shape inference (its sharding
        propagator runs each new op once on fake tensors of the global
        shapes) is not counted: it is no device's work."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        if on:
            original = getattr(ShardingPropagator, name)
            self._original = original
            counter = self

            def quiet(prop, op_schema):
                before, counter.counting = counter.counting, False
                counter.inferring += 1
                try:
                    return original(prop, op_schema)
                finally:
                    counter.inferring -= 1
                    counter.counting = before
            setattr(ShardingPropagator, name, quiet)
        else:
            setattr(ShardingPropagator, name, self._original)

    # ------------------------------------------------------------ memory
    def track(self, tensors) -> None:
        """Count the storage of `tensors` (made before the count, e.g. a
        step's inputs) as live until it is freed."""
        for t in _tensors(tensors):
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "cpu":      # host scalars, not the device's
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        size = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._seen[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    # ---------------------------------------------------------- charging
    def charge(self, name, flops, nbytes, dtype) -> None:
        if not self.counting:
            return
        c = self.cost
        key = str(dtype).split(".")[-1]
        c.flops_by_dtype[key] = c.flops_by_dtype.get(key, 0.0) + flops
        c.hbm_bytes += nbytes
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + nbytes
        c.kernels[name] = c.kernels.get(name, 0) + 1

    def _count(self, func, args, kwargs, out) -> None:
        c = self.cost
        name = func._overloadpacket.__name__
        packet = func._overloadpacket
        if packet in flop_registry:
            ins = _tensors(args)
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            key = str(ins[0].dtype).split(".")[-1] if ins else "float32"
            c.flops_by_dtype[key] = c.flops_by_dtype.get(key, 0.0) + flops
        if name in _NO_BYTES or getattr(func, "is_view", False):
            return
        ins, outs = _tensors(args) + _tensors(kwargs), _tensors(out)
        if name in _GATHERS:
            idx = sum(_nbytes(t) for t in ins[1:]
                      if not t.is_floating_point())
            nb = 2 * sum(map(_nbytes, outs)) + idx
        elif name in _SCATTERS:
            src = [t for t in ins[1:]]
            nb = 2 * sum(map(_nbytes, src))
        elif name.startswith(("zeros", "ones", "full", "fill", "arange",
                              "scalar_tensor", "new_zeros", "new_full",
                              "zero_")):
            nb = sum(map(_nbytes, outs))
        else:
            nb = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        c.hbm_bytes += nb
        c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + nb
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            self._collective(kind, args, ins, outs)

    def _collective(self, kind, args, ins, outs) -> None:
        c = self.cost
        operand = sum(map(_nbytes, ins))
        if kind == "all-gather":
            link = sum(map(_nbytes, outs)) or operand
            if _list_gather(args):
                link = sum(_nbytes(t) for t in _tensors(args[0]))
        elif kind == "all-reduce":
            link = 2 * operand
        elif kind == "all-to-all" and len(ins) > 1:
            link = _nbytes(ins[-1])         # (out, in): the send buffer
        else:
            link = operand
        ranks = _group_ranks(args)
        if ranks is None:
            self.warnings.append(f"{kind}: no process group found")
            ranks = [0]
        nodes = {r // self.devices_per_node for r in ranks}
        rate = (NVLINK_BYTES_PER_S if len(nodes) == 1
                else INTER_NODE_BYTES_PER_S)
        c.link_bytes += link
        c.collective_s += link / rate
        c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + link
        c.n_collectives += 1

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(isinstance(t, DTensor) for t in tree_flatten((args,
                                                             kwargs))[0]):
            # let DTensor's own dispatch run: the counter stays on the mode
            # stack, so its local ops (and redistributions) come back here
            # at the shards' shapes
            return NotImplemented
        out = func(*args, **kwargs)
        if self.inferring:
            return out
        if self.counting:
            self._count(func, args, kwargs, out)
        for t in _tensors(out):
            self._track(t)
        return out


def _list_gather(args) -> bool:
    """c10d's `allgather_` takes `[[out_0, ..., out_k-1]]` first."""
    return bool(args) and isinstance(args[0], (list, tuple)) and bool(
        args[0]) and isinstance(args[0][0], (list, tuple))


def analyze(counter: StepCounter) -> Dict:
    """Per-device totals and roofline terms (seconds), with the JAX
    package's keys (`repro/launch/roofline.py::analyze`)."""
    c = counter.cost
    compute_t = sum(f / PEAK_FLOPS[getattr(torch, k)]
                    for k, f in c.flops_by_dtype.items())
    memory_t = c.hbm_bytes / HBM_BYTES_PER_S
    coll_t = c.collective_s
    dominant = max(("compute", compute_t), ("memory", memory_t),
                   ("collective", coll_t), key=lambda kv: kv[1])[0]
    return {
        "flops_per_device": c.flops,
        "flops_by_dtype": dict(c.flops_by_dtype),
        "hbm_bytes_per_device": c.hbm_bytes,
        "hbm_bytes_fused_per_device": c.hbm_bytes,
        "link_bytes_per_device": c.link_bytes,
        "coll_bytes_by_type": dict(c.coll_bytes),
        "n_collectives": c.n_collectives,
        "compute_time_s": compute_t,
        "memory_time_s": memory_t,
        "memory_time_fused_s": memory_t,
        "collective_time_s": coll_t,
        "dominant": dominant,
        "bound_time_s": max(compute_t, memory_t, coll_t),
        "bytes_by_op": {k: v for k, v in sorted(c.bytes_by_op.items(),
                                                key=lambda kv: -kv[1])[:8]},
        "kernel_calls": dict(c.kernels),
        "warnings": counter.warnings[:10],
    }
