"""`torch.cuda.max_memory_allocated()` from the reset before ingress
(after the inputs are made and their device buffers freed) through the
window, in GiB."""


def read(run):
    return run.peak_mem_bytes / 2**30 if run.peak_mem_bytes else None
