"""Device ms launched under the port's `gre.message` spans (the message of
each edge, its activity mask and the select: `port_spans`, by the launch
each operation's correlation id links it to) in the traced window, over the
queries finished in it."""
from portbench import port_spans


def snapshot(dep):
    return port_spans.snapshot(dep)


def read(run):
    spans = run.snapshots["message_ms_per_query"][1]
    t = run.trace
    if spans is None or t is None or not t.queries:
        return None
    secs = spans.device_by_span_s.get("gre.message")
    return secs * 1e3 / t.queries if secs else None
