"""What a traced run (`--trace 1`) records: spans around the harness's
calls into the port, the combine calls' sizes, and the device trace of
the measured window.

Every span is a `torch.profiler.record_function` range named `SPAN +
label`, opened here around a call into the port (a deployment wraps the
port's methods on its own instances, or a module's function, for the
run), so the port itself is not edited.  The profiler records the window
(host ops and device kernels); the reduction below reads its raw events.
With tracing off nothing is wrapped, patched or recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional

import torch

from portbench import yardstick

SPAN = "portbench."
WINDOW = SPAN + "window"
_MISSING = object()


@dataclasses.dataclass
class TraceSummary:
    """The reduction of one traced window (seconds on the device's
    timeline, as the profiler gives it)."""

    window_s: float
    busy_s: float                     # union of device operations
    by_group_s: Dict[str, float]      # device time by `yardstick.GROUPS`
    idle_by_span_s: Dict[str, float]  # idle device time by the host span
    k1_least_s: Optional[float]       # K1's least time, summed over calls
    queries: int                      # queries finished inside it


class Tracer:
    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self._undo: List[tuple] = []
        self._prof = None
        self._window = None
        self._dense: Dict[tuple, list] = {}   # (id(seg_ptr), v, d) -> ...
        self._tile_bytes = 0

    # ----------------------------------------------------------- spans
    def span(self, label: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN + label)

    def wrap(self, owner, attr: str, label: str) -> None:
        """Run `owner.attr` (a method of an instance, or a module's
        function) inside the span `label`, until `close`."""
        if self.enabled:
            self._replace(owner, attr, self._spanned(getattr(owner, attr),
                                                     label))

    def _spanned(self, fn, label):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(SPAN + label):
                return fn(*args, **kwargs)
        return wrapper

    def _replace(self, owner, attr, new) -> None:
        self._undo.append((owner, attr, vars(owner).get(attr, _MISSING)))
        setattr(owner, attr, new)

    def close(self) -> None:
        """Take back every wrapper, last first."""
        while self._undo:
            owner, attr, prev = self._undo.pop()
            if prev is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, prev)

    # ------------------------------------------------ combine call sizes
    def _record_combines(self) -> None:
        """Count every combine call on the card by its sizes at the
        `repro_torch.kernels.ops` level (the dense and the tile route),
        whatever implements it below, from here to `close`."""
        from repro_torch.kernels import ops
        dense, tile = ops.segment_combine, ops.tile_segment_combine

        def dense_call(msgs, dst, num_segments, op="sum", seg_ptr=None):
            if msgs.is_cuda and seg_ptr is not None:
                d = msgs[:1].numel()
                key = (id(seg_ptr), num_segments, d)
                entry = self._dense.setdefault(key, [seg_ptr, 0])
                entry[1] += 1
            return dense(msgs, dst, num_segments, op, seg_ptr=seg_ptr)

        def tile_call(msgs, dst, num_segments, op="sum", valid=None):
            if msgs.is_cuda:
                e = (int((dst < num_segments).sum()) if valid is None
                     else int(valid))
                self._tile_bytes += yardstick.route_bytes(
                    msgs.shape[0], e, msgs[:1].numel(), num_segments)
            return tile(msgs, dst, num_segments, op, valid)

        self._replace(ops, "segment_combine", dense_call)
        self._replace(ops, "tile_segment_combine", tile_call)

    def _k1_bytes(self) -> int:
        total = self._tile_bytes
        for (_, v, d), (seg_ptr, calls) in self._dense.items():
            e = int(seg_ptr[v]) - int(seg_ptr[0])
            total += calls * yardstick.combine_bytes(e, d, v)
        return total

    # ------------------------------------------------------ the window
    def start_window(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._record_combines()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    @property
    def tracing(self) -> bool:
        return self._prof is not None

    def stop_window(self, queries: int) -> TraceSummary:
        """End the traced window, in which `queries` finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        k1_bytes = self._k1_bytes()
        self.close()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        return summarise(events, k1_bytes, queries)


def summarise(events, k1_bytes: int, queries: int) -> TraceSummary:
    """Busy time, device time by group and idle time by host span inside
    the window, from the profiler's raw events (ns)."""
    from torch.autograd import DeviceType
    w0 = w1 = None
    device, spans = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
            elif name.startswith(SPAN):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name[len(SPAN):]))
        elif not name.startswith(SPAN):   # a span also shows on the
            device.append((e.start_ns(),      # device timeline: no op
                           e.start_ns() + e.duration_ns(), name))
    if w0 is None:
        raise RuntimeError("the profiler recorded no window span")
    by_group: Dict[str, float] = {}
    clipped = []
    for s, t, name in device:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        clipped.append((s, t))
        g = yardstick.group_of(name)
        by_group[g] = by_group.get(g, 0.0) + (t - s) * 1e-9
    busy = yardstick.merged(clipped)
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < w1:
        gaps.append((at, w1))
    least = None
    k1_time = sum(by_group.get(g, 0.0) for g in yardstick.K1_GROUPS)
    if k1_time > 0:
        least = k1_bytes / yardstick.HBM_BYTES_PER_S
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(t - s for s, t in busy) * 1e-9,
        by_group_s=by_group, idle_by_span_s=label_gaps(gaps, spans),
        k1_least_s=least, queries=queries)


def label_gaps(gaps, spans) -> Dict[str, float]:
    """Idle seconds by the innermost host span open at each gap's middle
    ("outside spans" where none is).  Spans of one thread nest."""
    spans = sorted(spans)
    out: Dict[str, float] = {}
    stack: list = []
    i = 0
    for s, t in gaps:            # gaps come sorted and disjoint
        mid = (s + t) / 2
        while i < len(spans) and spans[i][0] <= mid:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "outside spans"
        out[label] = out.get(label, 0.0) + (t - s) * 1e-9
    return out
