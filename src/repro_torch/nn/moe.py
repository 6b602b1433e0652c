"""Mixture-of-Experts FFN as a Scatter-Combine instance (the counterpart of
`repro/nn/moe.py`).

Token→expert dispatch is the paper's scatter (an active message whose
payload is the token's hidden state), and the weighted top-k merge is the
combine (⊕ = weighted sum).  The routing is the JAX package's, to the bit
where the inputs agree: router logits in float32, `top_k` with the lower
expert index first among equal gates, the weights renormalised, the
Switch aux loss from exact integer counts, the capacity
`max(8, round(T·top_k/E·cf))` with Python's `round`, and a stable argsort
of the hits by local expert that packs them into `[E_loc, C, D]` (hits
past an expert's capacity are dropped).  The token and weight maps are
written from the kept hits only.

On the card every data-dependent step is a kernel of the port: the
dispatch gather `x[tokmap]` is `ops.gather_rows` (its backward the
combine kernel K1), and the combine `out.at[tokmap].add(w·y)` is
`ops.route_sum` over a `GatherRoute` of the slots (K1, no `index_add_`
and no atomic), whose empty slots sum into one extra row that is cut
off.  Every shape is static (no `nonzero`, no host read), so a step runs
on fake tensors too (the dry run).  The expert products are plain
batched matmuls, which the JAX package leaves to XLA too.

The expert-sharded form follows the agent pattern: routing is computed
redundantly on every shard, each shard pre-combines the hits of its own
experts (a combiner agent), and one `comm.psum` merges the partials (the
single combiner→master message).  It takes a communicator of
`repro_torch.dist.comm` in place of JAX's `axis_name`.

Over a device mesh the tokens are split over the data axes too
(`token_comm`, a communicator of that group): the expert counts are
summed over it, so the capacity, each hit's position in its expert's
queue (the hits of lower ranks first) and the aux loss are the whole
batch's, and a sharded step keeps and drops the hits an unsharded one
does.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.nn.layers import ACTIVATIONS, dense_init


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, gated: bool, dtype=torch.float32
             ) -> Dict[str, torch.Tensor]:
    """`router [D, E]` float32, `w_in`/`w_gate [E, D, F]` and `w_out
    [E, F, D]` in `dtype`, drawn from `generator` on its device with the
    JAX package's scales."""
    dev = generator.device

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    p = {"router": dense_init(generator, d_model, n_experts, torch.float32),
         "w_in": normal((n_experts, d_model, d_ff), d_model ** -0.5),
         "w_out": normal((n_experts, d_ff, d_model), d_ff ** -0.5)}
    if gated:
        p["w_gate"] = normal((n_experts, d_model, d_ff), d_model ** -0.5)
    return p


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """(gates `[T, E]`, renormalised top-k weights `[T, K]`, expert ids
    `[T, K]`): float32 routing, equal gates taken lower index first (the
    order of `jax.lax.top_k`)."""
    gates = torch.softmax(x.float() @ router, dim=-1)
    _, order = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_i = order[:, :top_k]
    top_w = gates.gather(1, top_i)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return gates, top_w, top_i


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert holds: `max(8, round(T·top_k/E·cf))`, Python's
    `round`, as the JAX package computes it."""
    return int(max(8, round(tokens * top_k / n_experts * capacity_factor)))


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each of `0..n-1` in `ids` (int64; a static-shape
    `bincount`)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def dispatch(top_w: torch.Tensor, top_i: torch.Tensor, e_loc: int, my: int,
             cap: int, dtype, offset=None):
    """Pack this shard's hits into `[e_loc·cap]` slots: (tokmap int64 and
    wmap in `dtype`, each `[e_loc·cap]`, and the valid-slot mask).  The
    hits are sorted stably by local expert (other shards' hits last); a
    hit at position `pos >= cap` of its expert is dropped.  `offset`
    (`[e_loc]`, the hits other token shards put before these) moves each
    expert's positions up.  Only kept hits are written to a slot (the
    others to a trash slot that is cut off), so every slot has at most one
    writer."""
    t, k = top_i.shape
    dev = top_i.device
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    mine = torch.div(flat_e, e_loc, rounding_mode="floor") == my
    le = torch.where(mine, flat_e - my * e_loc, e_loc)
    le_s, order = torch.sort(le, stable=True)
    counts = _counts(le_s, e_loc + 1)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=dev) - offsets[le_s]
    if offset is not None:
        pos = pos + torch.cat([offset, offset.new_zeros(1)])[le_s]
    kept = (le_s < e_loc) & (pos < cap)
    n = e_loc * cap
    slot = torch.where(kept, le_s * cap + pos, n)
    tokmap = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, flat_t[order])[:n]
    wmap = torch.zeros(n + 1, dtype=dtype, device=dev).scatter_(
        0, slot, top_w.reshape(-1)[order].to(dtype))[:n]
    valid = torch.zeros(n + 1, dtype=torch.bool, device=dev).scatter_(
        0, slot, kept)[:n]
    return tokmap, wmap, valid


def _experts(params, b: torch.Tensor, act) -> torch.Tensor:
    """`[E, C, D]` through each expert's MLP -> `[E, C, D]`."""
    h = torch.einsum("ecd,edf->ecf", b, params["w_in"])
    if "w_gate" in params:
        h = act(torch.einsum("ecd,edf->ecf", b, params["w_gate"])) * h
    else:
        h = act(h)
    return torch.einsum("ecf,efd->ecd", h, params["w_out"])


def _partial(params, x, top_w, top_i, act, my, cap, offset):
    """Shard `my`'s pre-combined output `[T, D]`: its kept hits through
    its experts, weighted and summed per token (the empty slots into a
    row T that is cut off)."""
    t, d = x.shape
    e_loc = params["w_in"].shape[0]
    tokmap, wmap, valid = dispatch(top_w, top_i, e_loc, my, cap, x.dtype,
                                   None if offset is None
                                   else offset[my * e_loc:(my + 1) * e_loc])
    b = ops.gather_rows(x, tokmap)
    b = torch.where(valid[:, None], b, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
    y = _experts(params, b.reshape(e_loc, cap, d), act)
    combine = ops.GatherRoute.build(torch.where(valid, tokmap, t), t + 1)
    return ops.route_sum(wmap[:, None] * y.reshape(e_loc * cap, d),
                         combine)[:t]


def moe_ffn(params, x: torch.Tensor, top_k: int, n_experts: int,
            capacity_factor: float = 1.25, activation: str = "silu",
            comm=None, token_comm=None):
    """x: `[T, D]` tokens.  Returns (out `[T, D]` in x's dtype, the aux
    loss, a float32 scalar).

    `params` holds the router `[D, E]` (always the whole matrix) and the
    expert weights.  Without `comm` it holds all `E` experts.  With `comm`
    (a `StackedComm` or `ProcessGroupComm` of `comm.k` expert shards,
    each of `E / comm.k` experts), `params` is the list of the
    shards this process holds, in the order of `comm.shards` (one dict on
    a rank of a process group): each shard's partial is pre-combined, one
    `comm.psum` sums them in shard order, and the result is the whole
    output.

    `token_comm` (a `ProcessGroupComm` over the ranks that split the
    tokens, each holding as many) makes the capacity, the queue positions
    and the aux loss those of all their tokens together.
    """
    act = ACTIVATIONS[activation]
    if comm is not None:
        shards = list(params) if isinstance(params, (list, tuple)) else [
            params]
        if len(shards) != len(comm.shards):
            raise ValueError(f"{len(shards)} expert shards for a "
                             f"communicator holding {len(comm.shards)}")
        n_shards = comm.k
        router = shards[0]["router"]
    else:
        shards, router, n_shards = [params], params["router"], 1
    e_loc = shards[0]["w_in"].shape[0]
    if e_loc * n_shards != n_experts:
        raise ValueError(f"{e_loc} experts a shard x {n_shards} shards != "
                         f"{n_experts}")
    t = x.shape[0]
    gates, top_w, top_i = route(router, x, top_k)
    counts = _counts(top_i.reshape(-1), n_experts)
    offset = None
    if token_comm is None:
        # Switch load-balance loss: E · mean(frac_tokens · frac_prob)
        aux = n_experts * torch.mean((counts.float() / (t * top_k))
                                     * gates.mean(0))
    else:
        every = token_comm.all_gather(counts[None])       # [ranks, E]
        offset = every[:token_comm.rank].sum(0)
        t = t * token_comm.k
        probs = token_comm.psum(gates.sum(0)[None])[0] / t
        aux = n_experts * torch.mean((every.sum(0).float() / (t * top_k))
                                     * probs)
    cap = capacity(t, top_k, n_experts, capacity_factor)
    if comm is None:
        return _partial(params, x, top_w, top_i, act, 0, cap, offset), aux
    partials = torch.stack([
        _partial(p, x, top_w, top_i, act, s, cap, offset)
        for p, s in zip(shards, comm.shards)])
    return comm.psum(partials)[0], aux


def moe_ffn_reference(params, x: torch.Tensor, top_k: int, n_experts: int,
                      activation: str = "silu") -> torch.Tensor:
    """Dense oracle: every token through its top-k experts exactly (no
    capacity drops), from the `[T, E, D]` outputs of all experts.  For
    tests and the chip's hold."""
    act = ACTIVATIONS[activation]
    _, top_w, top_i = route(params["router"], x, top_k)
    h = torch.einsum("td,edf->tef", x, params["w_in"])
    if "w_gate" in params:
        h = act(torch.einsum("td,edf->tef", x, params["w_gate"])) * h
    else:
        h = act(h)
    y = torch.einsum("tef,efd->ted", h, params["w_out"])
    sel = y.gather(1, top_i[:, :, None].expand(-1, -1, y.shape[-1]))
    return torch.einsum("tk,tkd->td", top_w.to(x.dtype), sel)
