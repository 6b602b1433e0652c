"""The combine calls' least time over their device time, in %: each
call's bytes at the `kernels.ops` level (`yardstick.combine_bytes` on the
dense route, `route_bytes` on the tile route) over 3.35 TB/s, summed,
divided by the device time of the combine kernel's and the compaction's
kernels in the traced window."""
from portbench import yardstick


def read(run):
    t = run.trace
    if t is None or t.k1_least_s is None:
        return None
    time_s = sum(t.by_group_s.get(g, 0.0) for g in yardstick.K1_GROUPS)
    return 100.0 * t.k1_least_s / time_s
