"""Spans of the port for `torch.profiler`.

`span(name)` opens the range `gre.<name>` while a profiler records, and is
one shared no-op context otherwise: with nothing recording a span costs one
flag read.  The ranges are the profiler's fast record function, the kind
that `aten` ops open: they stand on the host timeline of the profiler's
trace, which shares its clock with the device's, and add no range to the
device timeline (a `torch.profiler.record_function` range would also show
there, over the kernels launched inside it).

The spans of the BSP loop:

  core/plan.py      run > superstep > scatter_combine; halt_test
  core/engine.py    gather, message, combine (the dense route); apply;
                    init_state
  core/frontier.py  gather, message, combine (the tile route);
                    frontier_counts

Counters stay in the modules that count them (`plan.HOST_READS`,
`frontier.HOST_READS`, `kernels.segment_combine.LAUNCHES` and `HOST_READS`).
Ingress runs before any window a profiler traces: it opens no span, and
records its phases' host seconds instead (`timed`,
`DevicePartition.ingress_s`).
"""
from __future__ import annotations

import contextlib
import functools
import time

from torch._C._profiler import _RecordFunctionFast as _record
from torch.autograd import profiler as _profiler

PREFIX = "gre."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The range `gre.<name>` while a profiler records, else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _record(PREFIX + name)


def spanned(name: str):
    """Decorator: run the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def timed(record: dict, key: str):
    """The host seconds the block took, in `record[key]`."""
    t0 = time.perf_counter()
    yield
    record[key] = time.perf_counter() - t0
