"""The deployment's `ingress` (`deploy/<deployment>.py`: the `engine`
deployment's is `DevicePartition.from_graph` of the whole graph), host
clock around the call, ended by a synchronise."""


def read(run):
    return run.ingress_seconds
