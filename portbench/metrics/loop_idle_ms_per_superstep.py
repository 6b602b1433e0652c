"""Idle device ms inside the port's BSP loop over its supersteps, in the
traced window: the idle gaps whose middle lies inside a `gre.run` span
(`port_spans`), over the `gre.superstep` spans opened.  The loop's own
host time a superstep: its launches, its halt test's read, its Python;
and, while `deploy/engine.py` wraps the engine's methods in the
benchmark's own spans, those wrappers' host time too."""
from portbench import port_spans


def snapshot(dep):
    return port_spans.snapshot(dep)


def read(run):
    spans = run.snapshots["loop_idle_ms_per_superstep"][1]
    if spans is None or spans.busy_s <= 0:
        return None
    steps = spans.counts.get("gre.superstep")
    if not steps:
        return None
    return spans.idle_in_s.get("gre.run", 0.0) * 1e3 / steps
