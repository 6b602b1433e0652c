"""Launches of the gather-message kernel (the port's counter
`kernels.gather_messages.LAUNCHES`, every form) over the queries finished
in the window: one a superstep while each superstep's dense scan forms its
messages in the kernel.  A port without the kernel, or a run whose
messages never reached it, reads nothing."""


def snapshot(dep):
    del dep
    try:
        from repro_torch.kernels import gather_messages
    except ImportError:
        return None
    return sum(gather_messages.LAUNCHES.values())


def read(run):
    before, after = run.snapshots["gather_launches_per_query"]
    if before is None or not run.completed or after == before:
        return None
    return (after - before) / len(run.completed)
