"""Basic functional layers (the counterpart of `repro/nn/layers.py`).

Weights are `[d_in, d_out]` and applied as `x @ W`, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.engine import resolve_device


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal(0, 1/sqrt(d_in)) weights `[d_in, d_out]`, drawn in float32
    on the generator's device, then cast to `dtype`."""
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Unit gains `[d]` on `device` (CUDA unless the caller asks for the
    CPU; without a card CUDA raises)."""
    return torch.ones((d,), dtype=dtype, device=resolve_device(device))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """The JAX rounding order: float32 statistics, the normalised value cast
    to x's dtype, then times gamma in that dtype."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * gamma.to(dt)


def mlp_init(generator: torch.Generator, dims, dtype=torch.float32):
    """`[{"w": [a, b], "b": [b]}]` for consecutive `dims`: `dense_init`
    weights drawn from `generator` in layer order, zero biases, on the
    generator's device."""
    return [{"w": dense_init(generator, a, b, dtype),
             "b": torch.zeros((b,), dtype=dtype, device=generator.device)}
            for a, b in zip(dims[:-1], dims[1:])]


def mlp_apply(params, x, act=F.silu, final_act=False):
    for i, p in enumerate(params):
        x = x @ p["w"] + p["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """Nemotron-4's activation (arXiv:2402.16819): relu(x)**2."""
    r = F.relu(x)
    return r * r


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": _gelu_tanh,
    "relu": F.relu,
    "squared_relu": squared_relu,
}
