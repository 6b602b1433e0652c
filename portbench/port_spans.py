"""The port's own spans (`gre.*`, opened by `repro_torch.trace`) in a
traced window: how often each opened, the idle device time inside each, and
the device time launched under each.

`tracing.Tracer` keeps only its own summary of the window.  A metric that
reads the port's spans defines `snapshot(deployment)` as this module's
`snapshot`: the harness calls it as the window opens and as it closes.  The
first call hands the run's tracer a hook on `stop_window` that reduces the
window's profile (`reduce`) as the tracer ends it, before the tracer lets
the profile go; every call after the window returns that reduction.  A run
without tracing reads None; a program without these spans reads zero
counts and empty sums.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from portbench import tracing, yardstick

PORT = "gre."
OUTSIDE = "outside spans"
UNATTRIBUTED = "unattributed"
# host events of the CUDA APIs (`cudaLaunchKernel`, `cuLaunchKernel`,
# `cudaMemcpyAsync`, ...): a launch whose correlation id its device
# operation carries.  Ops are `aten::...`, spans `gre.` or
# `portbench.`; the event's kind is not read (older profilers lack it).
LAUNCH_PREFIX = "cu"
_HELD = "_port_spans"       # the hook's state, an attribute of the tracer


@dataclasses.dataclass
class PortSpans:
    """The reduction of one traced window (seconds on the device's
    timeline, as the profiler gives it; spans under their full names)."""

    busy_s: float                         # union of device operations
    counts: Dict[str, int]                # port spans opened in the window
    idle_in_s: Dict[str, float]           # idle whose gap middle lies
    #                                       inside a span of the name
    idle_by_span_s: Dict[str, float]      # idle by the innermost span,
    #                                       the port's or the benchmark's
    device_by_span_s: Dict[str, float]    # device time by the innermost
    #                                       port span open at its launch
    device_annotations: int               # device-timeline ranges named
    #                                       after a port span


def snapshot(dep) -> Optional[PortSpans]:
    """As the window opens: arm the hook (None).  After it: the window's
    reduction (None without tracing)."""
    tracer = getattr(dep, "tracer", None)
    if tracer is None or not tracer.enabled:
        return None
    held = vars(tracer).get(_HELD)
    if held is None:
        held = {"summary": None}
        setattr(tracer, _HELD, held)
        stop = tracer.stop_window

        def stop_window(queries):
            profile = tracer._prof
            summary = stop(queries)
            held["summary"] = reduce(profile.profiler.kineto_results.events())
            return summary
        tracer.stop_window = stop_window
        return None
    return held["summary"]


def reduce(events) -> Optional[PortSpans]:
    """The port's spans in the window of the profiler's raw events (ns);
    None where the events hold no window.  Device operations are those
    `tracing.summarise` counts, so the idle gaps are its gaps."""
    from torch.autograd import DeviceType
    window = None
    spans: Dict[int, list] = {}       # thread -> (start, end, name)
    launches: Dict[int, tuple] = {}   # correlation id -> (start, thread)
    device = []                       # (start, end, correlation id)
    annotations = 0
    for e in events:
        name = e.name()
        s = e.start_ns()
        if e.device_type() == DeviceType.CPU:
            tid = e.start_thread_id()
            if name == tracing.WINDOW:
                window = (s, s + e.duration_ns(), tid)
            elif name.startswith((PORT, tracing.SPAN)):
                spans.setdefault(tid, []).append(
                    (s, s + e.duration_ns(), name))
            elif name.startswith(LAUNCH_PREFIX):
                launches[e.correlation_id()] = (s, tid)
        elif name.startswith(PORT):
            annotations += 1
        elif not name.startswith(tracing.SPAN):
            device.append((s, s + e.duration_ns(), e.correlation_id()))
    if window is None:
        return None
    w0, w1, main = window
    for group in spans.values():
        group.sort(key=lambda x: (x[0], -x[1]))
    counts: Dict[str, int] = {}
    for group in spans.values():
        for s, _, name in group:
            if name.startswith(PORT) and w0 <= s <= w1:
                counts[name] = counts.get(name, 0) + 1
    clipped, charged = [], {}         # charged: thread -> [(launch, s)]
    by_span: Dict[str, float] = {}
    for s, t, corr in device:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        clipped.append((s, t))
        launch = launches.get(corr)
        if launch is None:
            by_span[UNATTRIBUTED] = by_span.get(UNATTRIBUTED, 0.0) \
                + (t - s) * 1e-9
        else:
            charged.setdefault(launch[1], []).append(
                (launch[0], (t - s) * 1e-9))
    for tid, points in charged.items():
        points.sort()
        port = [x for x in spans.get(tid, ()) if x[2].startswith(PORT)]
        for (_, secs), stack in zip(points, open_spans(
                [p for p, _ in points], port)):
            label = stack[-1][2] if stack else OUTSIDE
            by_span[label] = by_span.get(label, 0.0) + secs
    busy = yardstick.merged(clipped)
    gaps, at = [], w0
    for s, t in busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if at < w1:
        gaps.append((at, w1))
    idle_in: Dict[str, float] = {}
    innermost: Dict[str, float] = {}
    for (s, t), stack in zip(gaps, open_spans(
            [(s + t) / 2 for s, t in gaps], spans.get(main, []))):
        secs = (t - s) * 1e-9
        label = stack[-1][2] if stack else OUTSIDE
        innermost[label] = innermost.get(label, 0.0) + secs
        for name in {x[2] for x in stack}:
            idle_in[name] = idle_in.get(name, 0.0) + secs
    return PortSpans(busy_s=sum(t - s for s, t in busy) * 1e-9,
                     counts=counts, idle_in_s=idle_in,
                     idle_by_span_s=innermost, device_by_span_s=by_span,
                     device_annotations=annotations)


def open_spans(points, spans):
    """For each of the sorted `points`, the stack of `spans` open at it,
    outermost first.  `spans` are `(start, end, name)` of one thread, which
    nest, sorted by start and, at one start, the longer first.  Each stack
    is yielded before the sweep moves on: read it, do not keep it."""
    stack: list = []
    i = 0
    for x in points:
        while i < len(spans) and spans[i][0] <= x:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        yield stack
