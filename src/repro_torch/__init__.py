"""PyTorch port of the GRE single-shard engine (paper Alg. 2), for CUDA.

The counterpart of the JAX package `repro`, module for module: host ingress
(`graph`), the Scatter-Combine engine (`core`), the hand-written CUDA
combine kernel and its plain PyTorch version (`kernels`), and the paper's
workload configs (`configs`).  This package imports neither `jax` nor
`repro`.
"""
