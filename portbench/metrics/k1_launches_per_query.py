"""Launches of the hand-written combine kernel (K1 on the dense route, K2
on the tile route: the port's counter `kernels.segment_combine.LAUNCHES`)
over the queries finished in the window.  One a superstep while each
superstep's combine is one kernel; none where the combines ran anywhere
but the kernel, and then nothing is read."""

ROUTES = ("dense", "tile")


def snapshot(dep):
    del dep
    from repro_torch.kernels import segment_combine
    return sum(segment_combine.LAUNCHES[r] for r in ROUTES)


def read(run):
    before, after = run.snapshots["k1_launches_per_query"]
    if not run.completed or after == before:
        return None
    return (after - before) / len(run.completed)
