"""Mean supersteps a query finished in the window used (`EngineState.step`
of a job)."""


def read(run):
    if not run.completed:
        return None
    return sum(r.supersteps for r in run.completed) / len(run.completed)
