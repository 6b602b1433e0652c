"""Decoder-only GQA LM, dense or MoE: forward, loss, prefill and decode
steps; the counterpart of `repro/models/transformer.py`.

Parameters live in an `LM` module: one `Layer` per decoder layer in a
`ModuleList`, in place of the JAX package's stacked `[L, ...]` layers and
their `lax.scan`.  Tensor names and layouts are the JAX package's (`wq`
`[d_model, n_heads·d_head]` applied as `x @ wq`, an MoE layer's `moe`
dict of `router`, `w_in`, `w_gate`, `w_out`, a KV cache `[L, B, max_len,
Kv, H]`), so `params_from_numpy` carries JAX weights over as they are.
The parameters are trainable; `prefill` and `decode_step` run without
autograd and update the KV cache in place.

Training (`lm_loss`): the embedding lookup is `ops.gather_rows`, whose
backward is the combine kernel's ⊕ = sum (the JAX package's `segment_sum`
backward of `embed_lookup`); `grad_cast` keeps the layer stack's backward
in the parameter dtype; with `cfg.remat` each layer is checkpointed
(`torch.utils.checkpoint`, non-reentrant), the counterpart of
`_scan_layers` at a `remat_block` of 1, so a step runs each layer's
attention forward twice and its backward once.  The distribution context
(`DistCtx`, activation and embedding sharding constraints, the expert
weights' FSDP gather) needs a device mesh and is not ported.

Entry points run on CUDA unless the caller passes `device="cpu"`; asked for
CUDA with no card present they raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.nn.attention import apply_rope, decode_attention, gqa_attention
from repro_torch.nn.ffn import ffn_apply, ffn_init
from repro_torch.nn.layers import dense_init, rmsnorm, rmsnorm_init
from repro_torch.nn.moe import moe_ffn, moe_init

_LAYER_TENSORS = ("ln_attn", "wq", "wk", "wv", "wo", "ln_ffn")


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


class Layer(nn.Module):
    """One decoder layer: RMSNorm, GQA attention, RMSNorm, then a dense
    FFN (`ffn`) or a mixture of experts (`moe`)."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name in _LAYER_TENSORS:
            setattr(self, name, _param(tensors[name]))
        block = "moe" if "moe" in tensors else "ffn"
        setattr(self, block, nn.ParameterDict(
            {k: _param(v) for k, v in tensors[block].items()}))


class LM(nn.Module):
    """Embedding `[padded_vocab, d]`, layers, final norm and, unless the
    embeddings are tied, the head `[d, padded_vocab]`."""

    def __init__(self, embed, layers, ln_out, head: Optional[torch.Tensor]):
        super().__init__()
        self.embed = _param(embed)
        self.layers = nn.ModuleList(layers)
        self.ln_out = _param(ln_out)
        self.head = None if head is None else _param(head)


# --------------------------------------------------------------------- init
def init_layer(cfg: LMConfig, generator: torch.Generator) -> Layer:
    dt, dev = cfg.param_dtype, generator.device
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    tensors = {"ln_attn": rmsnorm_init(d, dt, dev),
               "wq": dense_init(generator, d, nh * hd, dt),
               "wk": dense_init(generator, d, nkv * hd, dt),
               "wv": dense_init(generator, d, nkv * hd, dt),
               "wo": dense_init(generator, nh * hd, d, dt),
               "ln_ffn": rmsnorm_init(d, dt, dev)}
    if cfg.moe:
        tensors["moe"] = moe_init(generator, d, cfg.moe.d_ff_expert,
                                  cfg.moe.n_experts, cfg.gated, dt)
    else:
        tensors["ffn"] = ffn_init(generator, d, cfg.d_ff, cfg.gated, dt)
    return Layer(tensors)


def init_lm(cfg: LMConfig, generator: torch.Generator,
            device="cuda") -> LM:
    """Random weights drawn from `generator`, which must lie on `device`,
    with the JAX package's scales: dense weights N(0, 1/d_in), embedding
    N(0, 0.02²), norms 1."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dt = cfg.param_dtype
    layers = [init_layer(cfg, generator) for _ in range(cfg.n_layers)]
    embed = (torch.randn((cfg.padded_vocab, cfg.d_model), generator=generator,
                         device=generator.device) * 0.02).to(dt)
    head = (None if cfg.tie_embeddings
            else dense_init(generator, cfg.d_model, cfg.padded_vocab, dt))
    return LM(embed, layers, rmsnorm_init(cfg.d_model, dt, dev), head)


def params_from_numpy(tree, cfg: LMConfig, device="cuda") -> LM:
    """The JAX package's `init_lm` parameters, as numpy arrays (layers
    stacked `[L, ...]`, an MoE layer's experts `[L, E, ...]`; `head` absent
    when the embeddings are tied), as the port's `LM` in `cfg.param_dtype`
    on `device` (an MoE router stays float32, as in JAX)."""
    dev = resolve_device(device)

    def t(a, dtype=cfg.param_dtype):
        # a float32 copy: numpy has no bfloat16 that torch can wrap, and
        # JAX hands out read-only arrays
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)

    stacked = tree["layers"]
    block = "moe" if cfg.moe else "ffn"
    if block not in stacked:
        raise ValueError(f"{cfg.name}: the layers hold no {block!r} tensors")
    layers = []
    for i in range(cfg.n_layers):
        tensors = {name: t(stacked[name][i]) for name in _LAYER_TENSORS}
        tensors[block] = {k: t(v[i], torch.float32 if k == "router"
                               else cfg.param_dtype)
                          for k, v in stacked[block].items()}
        layers.append(Layer(tensors))
    head = tree.get("head")
    if (head is None) != cfg.tie_embeddings:
        raise ValueError("a 'head' is present exactly when the embeddings "
                         "are not tied")
    return LM(t(tree["embed"]), layers, t(tree["ln_out"]),
              None if head is None else t(head))


# ------------------------------------------------------------------ forward
def _qkv(p: Layer, x, cfg: LMConfig, positions):
    """Normed projections with RoPE: q `[B, S, Kv, G, H]`, k, v
    `[B, S, Kv, H]`; `positions` broadcasts against `[B, heads, S]`."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv, cfg.d_head
    h = rmsnorm(x, p.ln_attn)
    q = (h @ p.wq).reshape(b, s, nh, hd).transpose(1, 2)
    k = (h @ p.wk).reshape(b, s, nkv, hd).transpose(1, 2)
    v = (h @ p.wv).reshape(b, s, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k, positions, cfg.rope_theta).transpose(1, 2)
    return q.reshape(b, s, nkv, nh // nkv, hd), k, v


def _attention_block(p: Layer, x, cfg: LMConfig, positions):
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    o = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl)
    return x + o.reshape(b, s, cfg.n_heads * cfg.d_head) @ p.wo, (k, v)


def _ffn_block(p: Layer, x, cfg: LMConfig):
    """(x + the FFN or MoE of the normed x, the MoE aux loss or 0.0)."""
    h = rmsnorm(x, p.ln_ffn)
    if cfg.moe is None:
        return x + ffn_apply(p.ffn, h, cfg.activation), 0.0
    b, s, d = x.shape
    m = cfg.moe
    out, aux = moe_ffn(p.moe, h.reshape(b * s, d), m.top_k, m.n_experts,
                       m.capacity_factor, cfg.activation)
    return x + out.reshape(b, s, d), aux


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def grad_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Identity whose backward casts the cotangent to `dtype`: the float32
    gradient of the loss's log-softmax then reaches the layer stack in the
    parameter dtype."""
    return _GradCast.apply(x, dtype)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """`embed[tokens]` (`tokens [B, S]` -> `[B, S, d]`) through
    `ops.gather_rows`: its backward is the ⊕ = sum of the gradient rows
    into the table, the combine kernel on a CUDA tensor."""
    b, s = tokens.shape
    return ops.gather_rows(embed, tokens.reshape(-1)).reshape(b, s, -1)


def _logits(params: LM, x, cfg: LMConfig):
    """Final norm, head, and the vocab-padding columns masked to the
    float32 minimum (which makes the logits float32, as in JAX)."""
    x = rmsnorm(x, params.ln_out)
    head = params.embed.T if params.head is None else params.head
    logits = x @ head
    if cfg.padded_vocab == cfg.vocab:
        return logits
    mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
    return torch.where(mask, logits.float(), torch.finfo(torch.float32).min)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)[:, None, :]


def _layer(p: Layer, x, cfg: LMConfig, positions):
    x, _ = _attention_block(p, x, cfg, positions)
    x, aux = _ffn_block(p, x, cfg)
    return x, torch.as_tensor(aux, dtype=torch.float32, device=x.device)


def lm_forward(params: LM, tokens: torch.Tensor, cfg: LMConfig):
    """tokens `[B, S]` -> (logits `[B, S, padded_vocab]`, the MoE aux loss
    averaged over the layers, a float32 scalar; 0 for a dense config).
    With `cfg.remat` and autograd recording, each layer is checkpointed
    and recomputed in the backward."""
    b, s = tokens.shape
    x = embed_lookup(params.embed, tokens)
    positions = _positions(b, s, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in params.layers:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer, p, x, cfg, positions, use_reentrant=False)
        else:
            x, a = _layer(p, x, cfg, positions)
        aux = aux + a
    x = grad_cast(x, cfg.param_dtype)
    return _logits(params, x, cfg), aux / cfg.n_layers


def lm_loss(params: LM, batch: Dict[str, torch.Tensor], cfg: LMConfig,
            aux_weight: float = 0.01):
    """Mean next-token cross entropy in float32 over the `mask`ed
    positions (all when absent), plus `aux_weight` times the MoE aux loss:
    (loss, {"ce": ..., "moe_aux": ...})."""
    logits, aux = lm_forward(params, batch["tokens"], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * aux, {"ce": loss, "moe_aux": aux}


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


@torch.no_grad()
def prefill(params: LM, tokens: torch.Tensor, cfg: LMConfig,
            max_len: Optional[int] = None):
    """Run the full prompt; returns (last-token logits `[B, V]`, a cache of
    `max_len` positions holding the prompt's k/v)."""
    b, s = tokens.shape
    max_len = max_len or s
    cache = init_cache(cfg, b, max_len, params.embed.dtype, tokens.device)
    x = params.embed[tokens]
    positions = _positions(b, s, tokens.device)
    for i, p in enumerate(params.layers):
        x, (k, v) = _attention_block(p, x, cfg, positions)
        x, _ = _ffn_block(p, x, cfg)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["len"].fill_(s)
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


@torch.no_grad()
def decode_step(params: LM, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, cfg: LMConfig):
    """One decode step.  token `[B]` int; cache from `init_cache`/`prefill`.
    Returns (logits `[B, V]`, the cache, updated in place).

    Every slot writes its new k/v at `pos = cache["len"]`, clamped into the
    cache as `dynamic_update_slice` clamps, free slots included, and every
    slot's `len` grows by one: the JAX package's step, row for row.
    """
    b = token.shape[0]
    max_len = cache["k"].shape[2]
    x = params.embed[token[:, None]]                          # [B, 1, D]
    pos = cache["len"]                                        # [B]
    rows = torch.arange(b, device=token.device)
    slot = pos.clamp(0, max_len - 1).long()
    positions = pos[:, None, None]
    for i, p in enumerate(params.layers):
        q, k, v = _qkv(p, x, cfg, positions)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[rows, slot] = k[:, 0]
        v_c[rows, slot] = v[:, 0]
        o = decode_attention(q, k_c, v_c, pos)
        x = x + o.reshape(b, 1, cfg.n_heads * cfg.d_head) @ p.wo
        x, _ = _ffn_block(p, x, cfg)
    cache["len"] += 1
    return _logits(params, x, cfg)[:, 0], cache
