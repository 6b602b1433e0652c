"""Metric readers, one file each (`<metric>.py`), found by the metric's
name in `BENCHMARK.json`: `read(run)` takes a `harness.RunRecord` and
returns the value, or None where the run has nothing to read.  A reader
that needs a reading from around the window (a counter of the port) also
defines `snapshot(deployment)`: the harness calls it as the window opens
and as it closes, and hands the two readings to `read` in
`run.snapshots[<metric>]`."""
