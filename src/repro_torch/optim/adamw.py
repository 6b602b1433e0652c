"""AdamW with global-norm clipping and schedules (the counterpart of
`repro/optim/adamw.py`), as a `torch.optim.Optimizer`.

The arithmetic is the JAX package's, in its order: gradients in float32,
clipped by their global norm first; the step counter incremented before
the bias corrections; float32 moments; `delta + wd·p` before the multiply
by the learning rate; the update cast back to the parameter's dtype.
Step-dependent scalars (the schedule, the bias corrections) are float32,
as JAX computes them.  The weight decay applies to every parameter each
step, as in the JAX package; a parameter with no gradient counts as a
zero gradient.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Iterable, Optional

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, folded in order."""
    sq = [torch.sum(t.to(torch.float32) ** 2) for t in tensors]
    return torch.sqrt(functools.reduce(torch.add, sq))


def cosine_warmup(warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to 1 over `warmup` steps, then a cosine decay to
    `floor` at `total`: `sched(step) -> float32 tensor`."""
    def sched(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return sched


class AdamW(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01,
                 clip_norm: Optional[float] = 1.0,
                 schedule: Optional[Callable] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.clip_norm = clip_norm
        self.schedule = schedule
        self.steps = 0

    @torch.no_grad()
    def step(self, closure=None, grads=None):
        """One update.  `grads`, when given, are the gradients to use in
        parameter order (any float dtype, e.g. the float32 output of
        gradient decompression for bfloat16 parameters) in place of each
        parameter's `.grad`."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        items = [(group, p) for group in self.param_groups
                 for p in group["params"]]
        if grads is None:
            grads = [p.grad for _, p in items]
        g32 = [(torch.zeros_like(p, dtype=torch.float32) if g is None
                else g.to(torch.float32)) for (_, p), g in zip(items, grads)]
        if self.clip_norm is not None and g32:
            gn = global_norm(g32)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            g32 = [g * scale for g in g32]
        self.steps += 1
        step = _f32(self.steps)
        mult = self.schedule(step) if self.schedule else None
        for (group, p), g in zip(items, g32):
            b1, b2 = group["b1"], group["b2"]
            lr = (group["lr"] if mult is None
                  else float(group["lr"] * mult))
            b1c = float(1.0 - b1 ** step)
            b2c = float(1.0 - b2 ** step)
            st = self.state[p]
            if not st:
                st["m"] = torch.zeros_like(p, dtype=torch.float32)
                st["v"] = torch.zeros_like(p, dtype=torch.float32)
            st["m"] = b1 * st["m"] + (1 - b1) * g
            st["v"] = b2 * st["v"] + (1 - b2) * g * g
            mhat = st["m"] / b1c
            vhat = st["v"] / b2c
            delta = mhat / (torch.sqrt(vhat) + group["eps"])
            p32 = p.to(torch.float32)
            delta = delta + group["weight_decay"] * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
        return loss
