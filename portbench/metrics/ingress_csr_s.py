"""The src-sorted CSR index and its degree buckets of ingress
(`csr_layout`, `degree_buckets`): the host seconds the port records for
that phase of `DevicePartition.from_graph` (`ingress_s["csr"]`).  The
snapshot as the window opens holds every phase the partition recorded.
Nothing is read from a port that records no phases."""


def snapshot(dep):
    part = getattr(dep, "part", None)
    return dict(getattr(part, "ingress_s", None) or {})


def read(run):
    return run.snapshots["ingress_csr_s"][0].get("csr")
