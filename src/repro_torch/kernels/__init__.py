# The port's hand-written CUDA kernels (csrc/, built with nvcc at first use
# by _build.py) beside their plain PyTorch versions: the Scatter-Combine ⊕
# (segment_combine.py) and flash attention (flash_attention.py); ops.py
# picks the route by the tensors' device and carries the ⊕'s gradients.
