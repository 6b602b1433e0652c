# The Scatter-Combine ⊕ as a hand-written CUDA kernel (csrc/, built with nvcc
# at first use by _build.py) beside its plain PyTorch version
# (segment_combine.py); ops.py picks the route by the tensors' device.
