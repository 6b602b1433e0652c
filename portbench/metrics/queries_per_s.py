"""Queries finished in the window over the window's seconds (host clock;
the window closes at the end of the step that crosses `--seconds`)."""


def read(run):
    return len(run.completed) / run.window_s if run.completed else None
