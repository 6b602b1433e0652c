"""The port's host reads in the window (its counters: the halt test's,
`core.plan.HOST_READS`; the frontier counts', `core.frontier.HOST_READS`;
the compaction totals', `kernels.segment_combine.HOST_READS`) over the
supersteps of the queries finished in it.  Nothing is read from a port
that lacks one of the counters."""
import importlib

MODULES = ("repro_torch.core.plan", "repro_torch.core.frontier",
           "repro_torch.kernels.segment_combine")


def snapshot(dep):
    del dep
    total = 0
    for name in MODULES:
        reads = getattr(importlib.import_module(name), "HOST_READS", None)
        if reads is None:
            return None
        total += sum(reads.values())
    return total


def read(run):
    before, after = run.snapshots["host_reads_per_superstep"]
    steps = sum(r.supersteps for r in run.completed)
    if before is None or after is None or not steps:
        return None
    return (after - before) / steps
