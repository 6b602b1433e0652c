"""Deployments, one file each (`<name>.py`), named by a configuration's
`deployment`: how the port is set up on the graph and how a query reaches
it.  Each defines `ingress(graph, cfg, seed, device)`, which builds the
deployment's device state from the host `Graph` (the harness times it),
and `Deployment(cfg, state, kinds, tracer)` on that state, with
`submit(request)`, `step()` (advance; return the requests finished, their
`result` on the host in original vertex ids), `warmed_up()` and
`close()`."""
