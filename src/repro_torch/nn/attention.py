"""Grouped-query attention with RoPE: reference, chunked (flash) and KV-cache
decode paths; the counterpart of `repro/nn/attention.py`.

`impl="chunked"` is the memory-bounded path every LM config uses.  In the
JAX package it is `flash_attention_jax`, the pure-XLA twin of the Pallas
flash kernel; here it is `kernels.ops.flash_attention`, which on a CUDA
tensor always launches the hand-written kernel (K3) and on a CPU tensor
runs its plain version; under autograd its backward is K3's backward
kernel (the plain backward on a CPU tensor).

Layouts are the JAX package's: q `[B, S, Kv, G, H]`, k/v `[B, S, Kv, H]`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops

NEG_INF = -1e30


def rope_freqs(d_head: int, theta: float = 10000.0,
               device="cuda") -> torch.Tensor:
    """`[d_head / 2]` rotation frequencies on `device` (CUDA unless the
    caller asks for the CPU; without a card CUDA raises)."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=resolve_device(device)) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: `[..., S, H]` with positions `[..., S]` (broadcastable).

    Rotates the interleaved pairs `(x[..., 0::2], x[..., 1::2])`, not the
    two halves of H (`rotate_half` of common Llama ports), as the JAX
    package does.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # [H/2]
    ang = positions[..., None].to(torch.float32) * freqs    # [..., S, H/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def _gqa_scores_ref(q, k, v, causal: bool, q_offset: int = 0):
    """Reference full-matrix attention.  q:[B,Sq,Kv,G,H] k,v:[B,Sk,Kv,H].
    Scores in the input dtype, softmax in float32."""
    sq, h = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) * (1.0 / math.sqrt(h))
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(q.dtype), v)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, impl: str = "reference"
                  ) -> torch.Tensor:
    """q: `[B, Sq, n_kv, group, d_head]`; k, v: `[B, Sk, n_kv, d_head]`.

    The JAX package's `q_chunk`/`kv_chunk` have no counterpart: the kernel
    runs at its own tile sizes and takes any Sq and Sk.
    """
    if impl == "reference":
        return _gqa_scores_ref(q, k, v, causal)
    if impl == "chunked":
        return ops.flash_attention(q, k, v, causal)
    raise ValueError(impl)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor
                     ) -> torch.Tensor:
    """Single-step decode: q `[B, 1, Kv, G, H]`; caches `[B, S, Kv, H]`;
    cache_len `[B]`, the valid prefix length (the new token's position).

    A full softmax over `arange(S) <= cache_len`, in plain products: the
    JAX package runs it as an einsum outside any Pallas kernel too.
    """
    s_len, h = k_cache.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k_cache) * (1.0 / math.sqrt(h))
    valid = (torch.arange(s_len, device=q.device)[None, :]
             <= cache_len[:, None])                               # [B, S]
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(q.dtype), v_cache)
