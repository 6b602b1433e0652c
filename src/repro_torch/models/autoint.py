"""AutoInt (arXiv:1810.11921): self-attention feature interaction for CTR,
the counterpart of `repro/models/autoint.py`.

Hot path: the embedding lookup over 39 fields of a multi-million-row
concatenated table, `kernels.ops.gather_rows`, whose table gradient is
one launch of the combine kernel over the ids-sorted order (no float
atomic).  Distributed serving row-shards the table and uses the
combiner-agent pattern (local masked partial lookups + ONE psum):
`repro_torch.nn.embedding.sharded_embedding_lookup`.  The field
interaction is plain einsum attention over the fields, as in the JAX
package (no Pallas kernel there either).  Entry points build on CUDA
unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import RecSysConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models.gnn import _leaf, _map, leaves_from_numpy
from repro_torch.nn.embedding import embedding_init, embedding_lookup
from repro_torch.nn.layers import dense_init


def field_offsets(cfg: RecSysConfig) -> np.ndarray:
    """Start row of each field in the concatenated embedding table."""
    return np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]]).astype(np.int64)


def init_autoint(generator: torch.Generator, cfg: RecSysConfig,
                 device="cuda"):
    """Random parameters drawn from `generator` (on `device`) with the JAX
    package's tree, shapes and scales (the table N(0, 0.05²), attention
    projections `dense_init`, a zero final bias): leaf tensors that
    require gradients."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    d, da = cfg.embed_dim, cfg.d_attn
    params = {
        "table": embedding_init(generator, cfg.total_rows(), d),
        "layers": [],
        "final": dense_init(generator, cfg.n_sparse * da, 1),
        "final_b": torch.zeros((1,), device=dev),
    }
    d_in = d
    for _ in range(cfg.n_attn_layers):
        params["layers"].append({
            name: dense_init(generator, d_in, da)
            for name in ("wq", "wk", "wv", "wr")})   # wr: residual
        d_in = da
    return _map(_leaf, params)


def params_from_numpy(tree, cfg: RecSysConfig, device="cuda"):
    """The JAX package's `init_autoint` parameters, as numpy arrays in its
    tree, as the port's tree of float32 leaf tensors on `device`."""
    if tuple(tree["table"].shape) != (cfg.total_rows(), cfg.embed_dim):
        raise ValueError(f"table {tuple(tree['table'].shape)}, config "
                         f"{(cfg.total_rows(), cfg.embed_dim)}")
    return leaves_from_numpy(tree, device)


def interact(params, emb: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """emb [B, F, d] -> AutoInt representation [B, F*d_attn]."""
    B, F, _ = emb.shape
    nh = cfg.n_heads
    h = emb
    for lp in params["layers"]:
        dh = cfg.d_attn // nh
        q = (h @ lp["wq"]).reshape(B, F, nh, dh)
        k = (h @ lp["wk"]).reshape(B, F, nh, dh)
        v = (h @ lp["wv"]).reshape(B, F, nh, dh)
        s = torch.einsum("bfnh,bgnh->bnfg", q, k) / float(np.sqrt(dh))
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bnfg,bgnh->bfnh", a, v).reshape(B, F, nh * dh)
        h = torch.relu(o + h @ lp["wr"])
    return h.reshape(B, F * cfg.d_attn)


def autoint_logits(params, ids: torch.Tensor, cfg: RecSysConfig,
                   lookup_fn=None) -> torch.Tensor:
    """ids [B, F]: GLOBAL row ids (field offsets already added).
    `lookup_fn(table, ids) -> [B, F, d]` replaces the whole-table lookup
    (e.g. `sharded_embedding_lookup` over a communicator's shards)."""
    if lookup_fn is None:
        emb = embedding_lookup(params["table"], ids)      # [B, F, d]
    else:
        emb = lookup_fn(params["table"], ids)
    rep = interact(params, emb, cfg)
    return (rep @ params["final"] + params["final_b"])[:, 0]


def autoint_loss(params, batch: Dict[str, torch.Tensor], cfg: RecSysConfig,
                 lookup_fn=None) -> torch.Tensor:
    """Mean binary cross-entropy with logits, in the JAX package's form."""
    logits = autoint_logits(params, batch["ids"], cfg, lookup_fn)
    y = batch["labels"].to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def retrieval_scores(params, ids: torch.Tensor, cand_table: torch.Tensor,
                     proj: torch.Tensor, cfg: RecSysConfig) -> torch.Tensor:
    """Retrieval scoring: one query's AutoInt representation against N
    candidates via a single batched dot product (no loop).

    ids [1, F]; cand_table [N, d_attn]; proj [F*d_attn, d_attn]."""
    rep = interact(params, embedding_lookup(params["table"], ids), cfg)
    qvec = rep @ proj                                          # [1, d_attn]
    return (cand_table @ qvec[0]).reshape(-1)                  # [N]


def synth_batch(generator: torch.Generator, cfg: RecSysConfig,
                batch: int) -> Dict[str, torch.Tensor]:
    """Synthetic criteo-like batch with power-law id distribution, drawn
    from `generator` on its device (the JAX package's recipe; the streams
    differ)."""
    dev = generator.device
    offs = torch.from_numpy(field_offsets(cfg)).to(dev)
    sizes = torch.tensor(cfg.vocab_sizes, device=dev)
    u = torch.rand((batch, cfg.n_sparse), generator=generator, device=dev)
    ids = ((u ** 3.0 * (sizes - 1)).to(torch.int32) + offs[None, :]).to(
        torch.int32)
    labels = (torch.rand((batch,), generator=generator, device=dev)
              < 0.25).to(torch.int32)
    return {"ids": ids, "labels": labels}
