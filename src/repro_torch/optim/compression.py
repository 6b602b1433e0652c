"""int8 error-feedback gradient compression (the counterpart of
`repro/optim/compression.py`).

Before the cross-replica gradient reduce, each shard quantizes (grad +
error carry) to int8 with one scale a tensor; the dequantization error is
carried to the next step (error feedback).  Trees are dicts of tensors
keyed by name.  The arithmetic is the JAX package's: float32, the scale
`max(max|g|, 1e-12) / 127`, `torch.round` (half to even, as `jnp.round`)
and a clip to ±127.
"""
from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


def _quantize(g: torch.Tensor, e: torch.Tensor):
    g = g.to(torch.float32) + e
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale, g - q.to(torch.float32) * scale


def compress(tree: Tree, error: Tree):
    """(int8 tree, float32 scales, the new error tree)."""
    qs, scales, errs = {}, {}, {}
    for name, g in tree.items():
        qs[name], scales[name], errs[name] = _quantize(g, error[name])
    return qs, scales, errs


def decompress(qtree: Tree, scales: Tree) -> Tree:
    return {name: q.to(torch.float32) * scales[name]
            for name, q in qtree.items()}


def init_error(params: Tree) -> Tree:
    """Float32 zeros shaped like each parameter, on its device."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in params.items()}


def compressed_psum(tree: Tree, error: Tree, comm):
    """Error-feedback compressed all-reduce over the shards of `comm`
    (`repro_torch.dist.comm`): every leaf is `[k_local, ...]`, one row a
    shard held here.  Each row is quantized with its own scale, the int8
    values are summed as int32 by `comm.psum`, and the sum is dequantized
    with the mean of the shards' scales.  Returns (the summed float32
    tree, rows alike, and the new error tree)."""
    out, new_error = {}, {}
    for name, g in tree.items():
        rows = [_quantize(g[i], error[name][i]) for i in range(g.shape[0])]
        q = torch.stack([r[0] for r in rows]).to(torch.int32)
        scales = torch.stack([r[1] for r in rows])
        new_error[name] = torch.stack([r[2] for r in rows])
        mean_scale = comm.psum(scales) / comm.k
        shape = (-1,) + (1,) * (g.dim() - 1)
        out[name] = (comm.psum(q).to(torch.float32)
                     * mean_scale.reshape(shape))
    return out, new_error
