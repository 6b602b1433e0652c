"""Device ms of the "gather" kernels (`index_select` and other gathers,
`yardstick.GROUPS`) in the traced window, over the queries finished in
it."""


def read(run):
    t = run.trace
    if t is None or not t.queries or not t.by_group_s.get("gather"):
        return None
    return t.by_group_s["gather"] * 1e3 / t.queries
