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

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import LMConfig
from repro_torch.core.engine import resolve_device
from repro_torch.dist import comm as dcomm
from repro_torch.kernels import ops
from repro_torch.nn.attention import apply_rope, decode_attention, gqa_attention
from repro_torch.nn.ffn import ffn_apply, ffn_init
from repro_torch.nn.layers import dense_init, rmsnorm, rmsnorm_init
from repro_torch.nn.moe import moe_ffn, moe_init

_LAYER_TENSORS = ("ln_attn", "wq", "wk", "wv", "wo", "ln_ffn")


@dataclasses.dataclass(frozen=True)
class DistCtx:
    """A device mesh and its logical axes (None: one device).  The process
    groups of the axes are made at first use, by every rank in the same
    order."""
    mesh: Optional[object] = None     # torch DeviceMesh
    dp: Tuple[str, ...] = ()          # data axes, e.g. ("pod", "data")
    tp: Optional[str] = None          # tensor/expert axis, e.g. "model"
    batch_over_dp: bool = True        # else every dp rank holds the batch

    @property
    def n_ep(self) -> int:
        if self.mesh is None or self.tp is None:
            return 1
        return self._size(self.tp)

    def _size(self, axis: str) -> int:
        return self.mesh.shape[self.mesh.mesh_dim_names.index(axis)]

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp:
            n *= self._size(a)
        return n

    @functools.cached_property
    def tp_group(self):
        return self.mesh.get_group(self.tp)

    @functools.cached_property
    def dp_group(self):
        """The group of the ranks that share this rank's tp coordinate."""
        if len(self.dp) == 1:
            return self.mesh.get_group(self.dp[0])
        names = self.mesh.mesh_dim_names
        # the port's meshes (`launch.mesh.make_mesh`) lay the world's ranks
        # out row-major; the grid is numpy, so no tensor op runs (the dry
        # run's fake mode would refuse the mesh's own rank tensor)
        ranks = np.arange(self.mesh.size()).reshape(self.mesh.shape)
        ranks = ranks.transpose(
            [names.index(a) for a in self.dp] + [names.index(self.tp)])
        ranks = ranks.reshape(-1, self._size(self.tp))
        mine = None
        for j in range(ranks.shape[1]):   # every rank makes every group
            members = [int(r) for r in ranks[:, j]]
            g = dist.new_group(members)
            if dist.get_rank() in members:
                mine = g
        return mine

    @functools.cached_property
    def tp_rank(self) -> int:
        return dist.get_rank(self.tp_group)

    @functools.cached_property
    def tp_comm(self):
        return dcomm.ProcessGroupComm(group=self.tp_group)

    @functools.cached_property
    def dp_comm(self):
        return dcomm.ProcessGroupComm(group=self.dp_group)


LOCAL_CTX = DistCtx()


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
def _keep(tensors, shard, prefix):
    """`tensors` (a layer's dict, sub-dicts included) through `shard(name,
    tensor)` under `prefix`; as they are when `shard` is None."""
    if shard is None:
        return tensors
    return {k: (_keep(v, shard, f"{prefix}{k}.") if isinstance(v, dict)
                else shard(f"{prefix}{k}", v)) for k, v in tensors.items()}


def init_layer(cfg: LMConfig, generator: torch.Generator, shard=None,
               prefix: str = "") -> Layer:
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
    return Layer(_keep(tensors, shard, prefix))


def init_lm(cfg: LMConfig, generator: torch.Generator,
            device="cuda", shard=None) -> LM:
    """Random weights drawn from `generator`, which must lie on `device`,
    with the JAX package's scales: dense weights N(0, 1/d_in), embedding
    N(0, 0.02²), norms 1.  `shard(name, tensor)`, when given, maps each
    tensor to the block a mesh rank keeps as soon as it is drawn (the
    names of `LM.named_parameters()`), so the rank never holds more than
    one whole layer; the weights are those of the unsharded init."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dt = cfg.param_dtype
    keep = shard or (lambda name, t: t)
    layers = [init_layer(cfg, generator, shard, f"layers.{i}.")
              for i in range(cfg.n_layers)]
    embed = keep("embed", (torch.randn((cfg.padded_vocab, cfg.d_model),
                                       generator=generator,
                                       device=generator.device) * 0.02
                           ).to(dt))
    head = (None if cfg.tie_embeddings else keep("head", dense_init(
        generator, cfg.d_model, cfg.padded_vocab, dt)))
    return LM(embed, layers, keep("ln_out", rmsnorm_init(cfg.d_model, dt,
                                                         dev)), head)


def param_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of `LM.named_parameters()`, with nothing
    allocated."""
    d, hd, dt = cfg.d_model, cfg.d_head, cfg.param_dtype
    layer = {"ln_attn": ((d,), dt), "wq": ((d, cfg.n_heads * hd), dt),
             "wk": ((d, cfg.n_kv * hd), dt), "wv": ((d, cfg.n_kv * hd), dt),
             "wo": ((cfg.n_heads * hd, d), dt), "ln_ffn": ((d,), dt)}
    if cfg.moe:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        layer.update({"moe.router": ((d, e), torch.float32),
                      "moe.w_in": ((e, d, f), dt),
                      "moe.w_out": ((e, f, d), dt)})
        if cfg.gated:
            layer["moe.w_gate"] = ((e, d, f), dt)
    else:
        layer.update({"ffn.w_in": ((d, cfg.d_ff), dt),
                      "ffn.w_out": ((cfg.d_ff, d), dt)})
        if cfg.gated:
            layer["ffn.w_gate"] = ((d, cfg.d_ff), dt)
    out = {"embed": ((cfg.padded_vocab, d), dt)}
    for i in range(cfg.n_layers):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out["ln_out"] = ((d,), dt)
    if not cfg.tie_embeddings:
        out["head"] = ((d, cfg.padded_vocab), dt)
    return out


def params_from_numpy(tree, cfg: LMConfig, device="cuda", shard=None) -> LM:
    """The JAX package's `init_lm` parameters, as numpy arrays (layers
    stacked `[L, ...]`, an MoE layer's experts `[L, E, ...]`; `head` absent
    when the embeddings are tied), as the port's `LM` in `cfg.param_dtype`
    on `device` (an MoE router stays float32, as in JAX); `shard` as in
    `init_lm`."""
    dev = resolve_device(device)
    keep = shard or (lambda name, t: t)

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
        layers.append(Layer(_keep(tensors, shard, f"layers.{i}.")))
    head = tree.get("head")
    if (head is None) != cfg.tie_embeddings:
        raise ValueError("a 'head' is present exactly when the embeddings "
                         "are not tied")
    return LM(keep("embed", t(tree["embed"])), layers,
              keep("ln_out", t(tree["ln_out"])),
              None if head is None else keep("head", t(head)))


# ------------------------------------------------------------------ forward
def _qkv(p: Layer, x, cfg: LMConfig, positions, h=None):
    """Normed projections with RoPE: q `[B, S, Kv, G, H]`, k, v
    `[B, S, Kv, H]`; `positions` broadcasts against `[B, heads, S]`.  `h`
    is the normed input when the caller has it.  The head counts are the
    weights' (a rank's block of heads on a mesh)."""
    b, s, _ = x.shape
    hd = cfg.d_head
    nh, nkv = p.wq.shape[1] // hd, p.wk.shape[1] // hd
    h = rmsnorm(x, p.ln_attn) if h is None else h
    q = (h @ p.wq).reshape(b, s, nh, hd).transpose(1, 2)
    k = (h @ p.wk).reshape(b, s, nkv, hd).transpose(1, 2)
    v = (h @ p.wv).reshape(b, s, nkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k, positions, cfg.rope_theta).transpose(1, 2)
    return q.reshape(b, s, nkv, nh // nkv, hd), k, v


def _attention_block(p: Layer, x, cfg: LMConfig, positions,
                     ctx: "DistCtx" = LOCAL_CTX):
    if ctx.mesh is not None:
        return _attention_block_mesh(p, x, cfg, positions, ctx)
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    o = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl)
    return x + o.reshape(b, s, cfg.n_heads * cfg.d_head) @ p.wo, (k, v)


def _ffn_block(p: Layer, x, cfg: LMConfig, ctx: "DistCtx" = LOCAL_CTX,
               s_full: Optional[int] = None):
    """(x + the FFN or MoE of the normed x, the MoE aux loss or 0.0).  On
    a mesh `s_full` is the whole sequence's length."""
    if ctx.mesh is not None:
        return _ffn_block_mesh(p, x, cfg, ctx, s_full or x.shape[1])
    h = rmsnorm(x, p.ln_ffn)
    if cfg.moe is None:
        return x + ffn_apply(p.ffn, h, cfg.activation), 0.0
    b, s, d = x.shape
    m = cfg.moe
    out, aux = moe_ffn(p.moe, h.reshape(b * s, d), m.top_k, m.n_experts,
                       m.capacity_factor, cfg.activation)
    return x + out.reshape(b, s, d), aux


# ------------------------------------------------------------- on a mesh
def _seq_sharded(cfg: LMConfig, ctx: DistCtx, s_len: int) -> bool:
    """Whether the residual stream is split over tp along the sequence
    between layers (`cfg.seq_shard_activations`, when tp divides S)."""
    return (cfg.seq_shard_activations and ctx.n_ep > 1
            and s_len % ctx.n_ep == 0)


def _activation_constraint(x, cfg: LMConfig, ctx: DistCtx):
    """Between-layer activations: batch over dp (the rank's rows already),
    sequence over tp where `cfg.seq_shard_activations`: the rank's block
    of the sequence of a replicated `x`."""
    if ctx.mesh is None or not _seq_sharded(cfg, ctx, x.shape[1]):
        return x
    n = x.shape[1] // ctx.n_ep
    return x.narrow(1, ctx.tp_rank * n, n)


def _block_input(h, cfg, ctx, s_full):
    """A block's normed input over the whole sequence."""
    if _seq_sharded(cfg, ctx, s_full):
        return dcomm.group_all_gather(h, 1, ctx.tp_group)
    return h


def _block_output(y, cfg, ctx, split: bool):
    """A block's output as the residual stream holds it: the sum over tp
    of the ranks' parts (`split`) or this rank's whole, then the rank's
    block of the sequence when it is split."""
    seq = _seq_sharded(cfg, ctx, y.shape[1])
    if split:
        return (dcomm.group_reduce_scatter(y, 1, ctx.tp_group) if seq
                else dcomm.group_all_reduce(y, ctx.tp_group))
    return _activation_constraint(y, cfg, ctx) if seq else y


def _attention_block_mesh(p: Layer, x, cfg, positions, ctx):
    s_full = positions.shape[-1]
    h = _block_input(rmsnorm(x, p.ln_attn), cfg, ctx, s_full)
    b = h.shape[0]
    q, k, v = _qkv(p, h, cfg, positions, h=h)
    o = gqa_attention(q, k, v, causal=True, impl=cfg.attention_impl)
    y = o.reshape(b, s_full, -1) @ p.wo
    split = p.wq.shape[1] < cfg.n_heads * cfg.d_head
    return x + _block_output(y, cfg, ctx, split), (k, v)


def _expert_blocks(mp, ctx):
    """The layer's experts with their FSDP blocks gathered over dp (the
    gather's backward sums the gradient over dp and keeps the rank's
    block)."""
    out = dict(mp.items())
    if ctx.dp_size > 1:
        for name, dim in (("w_in", 1), ("w_gate", 1), ("w_out", 2)):
            if name in out and out[name].shape[dim] * ctx.dp_size == (
                    out["router"].shape[0]):
                out[name] = dcomm.group_all_gather(out[name], dim,
                                                   ctx.dp_group)
    return out


def _ffn_block_mesh(p: Layer, x, cfg, ctx, s_full):
    h = _block_input(rmsnorm(x, p.ln_ffn), cfg, ctx, s_full)
    b, s, d = h.shape
    if cfg.moe is None:
        y = ffn_apply(p.ffn, h, cfg.activation)
        return x + _block_output(y, cfg, ctx, ctx.n_ep > 1), 0.0
    m = cfg.moe
    tokens = ctx.dp_comm if ctx.dp_size > 1 and ctx.batch_over_dp else None
    out, aux = moe_ffn(_expert_blocks(p.moe, ctx), h.reshape(b * s, d),
                       m.top_k, m.n_experts, m.capacity_factor,
                       cfg.activation,
                       comm=ctx.tp_comm if ctx.n_ep > 1 else None,
                       token_comm=tokens)
    return x + _block_output(out.reshape(b, s, d), cfg, ctx, False), aux



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


def _layer(p: Layer, x, cfg: LMConfig, positions, ctx=LOCAL_CTX):
    x, _ = _attention_block(p, x, cfg, positions, ctx)
    x, aux = _ffn_block(p, x, cfg, ctx, positions.shape[-1])
    if not isinstance(aux, torch.Tensor):         # a dense layer's 0.0
        aux = x.new_zeros((), dtype=torch.float32)
    return x, aux


def _embed_mesh(embed: torch.Tensor, tokens: torch.Tensor, cfg: LMConfig,
                ctx: DistCtx):
    """The lookup in a table whose rows are split over tp: the rank's rows
    gathered (`ops.gather_rows`, its backward the combine kernel over the
    rank's tokens), the others zero, summed over tp (the rank's block of
    the sequence when it is split)."""
    b, s = tokens.shape
    if ctx.n_ep == 1:
        return embed_lookup(embed, tokens)
    rows = embed.shape[0]
    local = tokens - ctx.tp_rank * rows
    inside = (local >= 0) & (local < rows)
    g = ops.gather_rows(embed, local.clamp(0, rows - 1).reshape(-1))
    g = torch.where(inside.reshape(-1, 1), g,
                    torch.zeros((), dtype=g.dtype, device=g.device))
    return _block_output(g.reshape(b, s, -1), cfg, ctx, True)


def _logits_mesh(params: LM, x, cfg: LMConfig, ctx: DistCtx):
    """The rank's vocab block of the logits `[B, S, V/tp]` (padding
    columns masked by their global index)."""
    x = rmsnorm(x, params.ln_out)
    head = params.embed.T if params.head is None else params.head
    logits = x @ head
    if cfg.padded_vocab == cfg.vocab:
        return logits
    v_loc = logits.shape[-1]
    lo = ctx.tp_rank * v_loc if ctx.n_ep > 1 else 0
    mask = torch.arange(lo, lo + v_loc, device=x.device) < cfg.vocab
    return torch.where(mask, logits.float(), torch.finfo(torch.float32).min)


def _vocab_parallel_ll(logits: torch.Tensor, labels: torch.Tensor,
                       ctx: DistCtx) -> torch.Tensor:
    """log p(label) in float32 from the ranks' vocab blocks: the row max
    (no gradient) and the sum of exponentials all-reduced over tp, the
    label's logit from the rank that holds it."""
    z = logits.float()
    labels = labels.long()
    if ctx.n_ep == 1:
        return torch.log_softmax(z, dim=-1).gather(-1, labels[..., None])[
            ..., 0]
    group = ctx.tp_group
    z = z - dcomm.group_max(z.max(-1).values, group)[..., None]
    total = dcomm.group_all_reduce(z.exp().sum(-1), group)
    v_loc = z.shape[-1]
    lab = labels - ctx.tp_rank * v_loc
    inside = (lab >= 0) & (lab < v_loc)
    picked = z.gather(-1, lab.clamp(0, v_loc - 1)[..., None])[..., 0]
    picked = dcomm.group_all_reduce(torch.where(inside, picked, 0.0), group)
    return picked - total.log()


def lm_forward(params: LM, tokens: torch.Tensor, cfg: LMConfig,
               ctx: DistCtx = LOCAL_CTX):
    """tokens `[B, S]` -> (logits `[B, S, padded_vocab]`, the MoE aux loss
    averaged over the layers, a float32 scalar; 0 for a dense config).
    With `cfg.remat` and autograd recording, each layer is checkpointed
    and recomputed in the backward.  On a mesh (`ctx`), tokens are the
    rank's rows and the logits the rank's vocab block."""
    b, s = tokens.shape
    mesh = ctx.mesh is not None
    x = (_embed_mesh(params.embed, tokens, cfg, ctx) if mesh
         else embed_lookup(params.embed, tokens))
    positions = _positions(b, s, tokens.device)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for p in params.layers:
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _layer, p, x, cfg, positions, ctx, use_reentrant=False)
        else:
            x, a = _layer(p, x, cfg, positions, ctx)
        aux = aux + a
    x = grad_cast(x, cfg.param_dtype)
    if not mesh:
        return _logits(params, x, cfg), aux / cfg.n_layers
    if _seq_sharded(cfg, ctx, s):
        # unshard the sequence before the vocab projection, so the logits
        # land [B/dp, S, V/tp]
        x = dcomm.group_all_gather(x, 1, ctx.tp_group)
    return _logits_mesh(params, x, cfg, ctx), aux / cfg.n_layers


def lm_loss(params: LM, batch: Dict[str, torch.Tensor], cfg: LMConfig,
            ctx: DistCtx = LOCAL_CTX, aux_weight: float = 0.01):
    """Mean next-token cross entropy in float32 over the `mask`ed
    positions (all when absent), plus `aux_weight` times the MoE aux loss:
    (loss, {"ce": ..., "moe_aux": ...}).

    On a mesh the batch is the rank's rows, and the first value is the
    rank's share of the loss (the shares over every rank sum to it); the
    parts add "loss", the whole loss (no gradient)."""
    logits, aux = lm_forward(params, batch["tokens"], cfg, ctx)
    mesh = ctx.mesh is not None
    if mesh:
        ll = _vocab_parallel_ll(logits, batch["labels"], ctx)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    mask = batch.get("mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll.dtype)
    if not mesh:
        loss = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss + aux_weight * aux, {"ce": loss, "moe_aux": aux}
    split = ctx.dp_size > 1 and ctx.batch_over_dp
    count = mask.sum()
    if split:
        count = dcomm.group_all_reduce(count.detach(), ctx.dp_group)
    ce = -(ll * mask).sum() / torch.clamp(count, min=1.0)
    copies = ctx.n_ep * (1 if split else ctx.dp_size)
    share = ce / copies + aux_weight * aux / (ctx.n_ep * ctx.dp_size)
    with torch.no_grad():
        whole = (dcomm.group_all_reduce(ce, ctx.dp_group) if split
                 else ce.detach())
    return share, {"ce": whole, "moe_aux": aux.detach(),
                   "loss": whole + aux_weight * aux.detach()}


# ------------------------------------------------------------------ serving
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _serving_cfg(cfg: LMConfig, ctx: DistCtx) -> LMConfig:
    """Serving steps keep the sequence whole between layers (JAX's
    `prefill` and `decode_step` apply no activation constraint)."""
    if ctx.mesh is None or not cfg.seq_shard_activations:
        return cfg
    return dataclasses.replace(cfg, seq_shard_activations=False)


@torch.no_grad()
def prefill(params: LM, tokens: torch.Tensor, cfg: LMConfig,
            ctx: DistCtx = LOCAL_CTX, max_len: Optional[int] = None):
    """Run the full prompt; returns (last-token logits `[B, V]`, a cache of
    `max_len` positions holding the prompt's k/v).  On a mesh: the rank's
    rows, its kv heads in the cache and its vocab block of the logits."""
    b, s = tokens.shape
    max_len = max_len or s
    if ctx.mesh is None:
        cache = init_cache(cfg, b, max_len, params.embed.dtype,
                           tokens.device)
        x = params.embed[tokens]
    else:
        cfg = _serving_cfg(cfg, ctx)
        cache = _local_cache(params, cfg, b, max_len, tokens.device)
        x = _embed_mesh(params.embed, tokens, cfg, ctx)
    positions = _positions(b, s, tokens.device)
    for i, p in enumerate(params.layers):
        x, (k, v) = _attention_block(p, x, cfg, positions, ctx)
        x, _ = _ffn_block(p, x, cfg, ctx, s)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["len"].fill_(s)
    if ctx.mesh is not None:
        return _logits_mesh(params, x[:, -1:], cfg, ctx)[:, 0], cache
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def _local_cache(params: LM, cfg: LMConfig, b: int, max_len: int, device):
    """A cache for the rank's kv heads (the layers' `wk` blocks)."""
    kv_loc = params.layers[0].wk.shape[1] // cfg.d_head
    shape = (cfg.n_layers, b, max_len, kv_loc, cfg.d_head)
    dt = params.embed.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "len": torch.zeros((b,), dtype=torch.int32, device=device)}


@torch.no_grad()
def decode_step(params: LM, cache: Dict[str, torch.Tensor],
                token: torch.Tensor, cfg: LMConfig,
                ctx: DistCtx = LOCAL_CTX):
    """One decode step.  token `[B]` int; cache from `init_cache`/`prefill`.
    Returns (logits `[B, V]`, the cache, updated in place); on a mesh as
    `prefill` places them.

    Every slot writes its new k/v at `pos = cache["len"]`, clamped into the
    cache as `dynamic_update_slice` clamps, free slots included, and every
    slot's `len` grows by one: the JAX package's step, row for row.
    """
    b = token.shape[0]
    max_len = cache["k"].shape[2]
    mesh = ctx.mesh is not None
    if mesh:
        cfg = _serving_cfg(cfg, ctx)
        x = _embed_mesh(params.embed, token[:, None], cfg, ctx)
    else:
        x = params.embed[token[:, None]]                      # [B, 1, D]
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
        y = o.reshape(b, 1, -1) @ p.wo
        if mesh:
            y = _block_output(y, cfg, ctx,
                              p.wq.shape[1] < cfg.n_heads * cfg.d_head)
        x = x + y
        x, _ = _ffn_block(p, x, cfg, ctx, 1)
    cache["len"] += 1
    if mesh:
        return _logits_mesh(params, x, cfg, ctx)[:, 0], cache
    return _logits(params, x, cfg)[:, 0], cache
