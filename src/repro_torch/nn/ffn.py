"""Feed-forward blocks: gated (SwiGLU / LLaMA-style) and plain MLP
(Nemotron squared-ReLU); the counterpart of `repro/nn/ffn.py`."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.nn.layers import ACTIVATIONS, dense_init


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int,
             gated: bool, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    p = {"w_in": dense_init(generator, d_model, d_ff, dtype),
         "w_out": dense_init(generator, d_ff, d_model, dtype)}
    if gated:
        p["w_gate"] = dense_init(generator, d_model, d_ff, dtype)
    return p


def ffn_apply(params, x: torch.Tensor, activation: str = "silu"
              ) -> torch.Tensor:
    """`params` maps `w_in`, `w_out` and, when gated, `w_gate`."""
    act = ACTIVATIONS[activation]
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = act(x @ params["w_gate"]) * h
    else:
        h = act(h)
    return h @ params["w_out"]
