# The port's hand-written CUDA kernels (csrc/, built with nvcc at first use
# by _build.py) beside their plain PyTorch versions: the Scatter-Combine ⊕
# (segment_combine.py), flash attention (flash_attention.py) and
# EmbeddingBag (embedding_bag.py); ops.py picks the route by the tensors'
# device and carries the gradients.
