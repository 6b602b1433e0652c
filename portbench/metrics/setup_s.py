"""Process start to the window's start (host clock): imports, the kernel
build where it runs, the inputs, ingress, the deployment and warm-up."""


def read(run):
    return run.setup_seconds
