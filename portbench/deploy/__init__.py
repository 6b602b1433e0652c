"""Deployments, one file each (`<name>.py`), named by a configuration's
`deployment`: how the port is set up on the partition and how a query
reaches it.  Each defines `Deployment(cfg, part, kinds, tracer)` with
`submit(request)`, `step()` (advance; return the requests finished, their
`result` on the host), `warmed_up()` and `close()`."""
