"""Partition specs over a device mesh (the counterpart of
`repro/dist/sharding.py`) and the blocks a rank holds under them.

  * `lm_param_specs` returns `P` trees (a `PartitionSpec`: one entry a
    tensor dimension, None, a mesh axis name or a tuple of them) keyed
    like the port's parameters, with the JAX package's sharding: dense
    parts tensor-parallel over `tp` (Megatron column and row parallel),
    the embedding's rows over `tp`, MoE experts over `tp`.  An LM layer's
    spec is the JAX package's stacked `[L, ...]` spec without its layer
    axis (the port keeps one module a layer), under the names
    `layers.<i>.<tensor>`.
  * `lm_mesh_specs` is what a mesh training run stores, derived from
    `lm_param_specs`: attention's heads whole on every tp rank when tp
    does not divide the kv heads (the port's attention runs whole heads
    on a rank; JAX's GSPMD splits `wq`'s columns anyway), and the expert
    weights FSDP-sharded over the dp axes as the JAX MoE block's
    `shard_map` takes them (`w_in`/`w_gate` `[E, D, F]` over (tp, dp),
    `w_out` `[E, F, D]` over (tp, -, dp)), gathered over dp inside the
    block.
  * `local_shape` / `local_block` give a rank's block of a tensor under a
    spec (a tuple entry such as ("pod", "data") splits its dimension over
    each of those axes, major first).

The mesh step holds plain tensor blocks and moves them with
`dist.comm`'s collectives, so no DTensor reaches a kernel.  The JAX
package's batch, cache, recsys and optimizer spec trees, `to_shardings`,
`abstract_with_sharding` and `shard_map` have no counterpart: no path of
the port reads them (the dry run's cells place their arguments by
`local_shape`, AdamW's moments follow their blocks).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import LMConfig


class P(tuple):
    """A partition spec: entry i names the mesh axis (or axes) tensor
    dimension i is split over, None for none."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# ------------------------------------------------------------- utilities
def dp_entry(dp: Tuple[str, ...]):
    """A spec entry for the (possibly multi-axis) data dimension."""
    if not dp:
        return None
    return dp[0] if len(dp) == 1 else tuple(dp)


def local_shape(shape, spec: P, sizes: Dict[str, int],
                coords: Dict[str, int]):
    """(the shape of the block this mesh coordinate holds, its offset) of a
    tensor of `shape` under `spec`; a dimension split over several axes
    is split major axis first.  Dimensions must divide evenly."""
    out, offset = list(shape), [0] * len(shape)
    for d, e in enumerate(spec):
        if e is None:
            continue
        for axis in ((e,) if isinstance(e, str) else e):
            n = sizes[axis]
            if out[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split over {axis!r} ({n})")
            out[d] //= n
            offset[d] += coords[axis] * out[d]
    return tuple(out), tuple(offset)


def mesh_coords(mesh) -> Dict[str, int]:
    """This rank's coordinate on each named mesh axis."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_block(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec`, a contiguous
    copy that does not keep `t` alive: every rank holds `t` and cuts its
    own block, with no collective."""
    names = tuple(mesh.mesh_dim_names)
    shape, offset = local_shape(t.shape, spec, dict(zip(names, mesh.shape)),
                                mesh_coords(mesh))
    for d, (n, o) in enumerate(zip(shape, offset)):
        t = t.narrow(d, o, n)
    return t.clone(memory_format=torch.contiguous_format)


# ------------------------------------------------------------------ LM specs
def _lm_layer_specs(cfg: LMConfig, tp: Optional[str]) -> Dict[str, P]:
    """One layer's specs: the JAX package's stacked spec without its
    layer axis, keyed `wq`, `moe.w_in`, ..."""
    layer = {"ln_attn": P(None), "wq": P(None, tp), "wk": P(None, tp),
             "wv": P(None, tp), "wo": P(tp, None), "ln_ffn": P(None)}
    if cfg.moe:
        layer.update({"moe.router": P(None, None),
                      "moe.w_in": P(tp, None, None),
                      "moe.w_out": P(tp, None, None)})
        if cfg.gated:
            layer["moe.w_gate"] = P(tp, None, None)
    else:
        layer.update({"ffn.w_in": P(None, tp), "ffn.w_out": P(tp, None)})
        if cfg.gated:
            layer["ffn.w_gate"] = P(None, tp)
    return layer


def lm_param_specs(cfg: LMConfig, dp: Tuple[str, ...],
                   tp: Optional[str]) -> Dict[str, P]:
    """Specs keyed like `transformer.LM.named_parameters()`: Megatron
    style, qkv/ffn-in column-parallel over `tp`, wo/ffn-out row-parallel,
    the embedding row-sharded (vocab), MoE expert-sharded."""
    del dp                       # nothing is sharded over dp, as in JAX
    specs = {"embed": P(tp, None)}
    layer = _lm_layer_specs(cfg, tp)
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    specs["ln_out"] = P(None)
    if not cfg.tie_embeddings:
        specs["head"] = P(None, tp)
    return specs


def heads_split(cfg: LMConfig, tp_size: int) -> bool:
    """Whether attention's heads split over tp: the kv heads (and so the
    query heads of each) divide evenly."""
    return cfg.n_kv % tp_size == 0


def lm_mesh_specs(cfg: LMConfig, dp: Tuple[str, ...], tp: Optional[str],
                  sizes: Dict[str, int]) -> Dict[str, P]:
    """What a mesh training run stores (see the module docstring):
    `lm_param_specs` with attention whole on every tp rank when its kv
    heads do not divide, and the experts FSDP-sharded over the dp axes (when
    d_model divides their size)."""
    specs = dict(lm_param_specs(cfg, dp, tp))
    tp_size = sizes[tp] if tp else 1
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    wdp = dp_entry(dp)
    fsdp = cfg.moe is not None and dp and cfg.d_model % dp_size == 0
    for name in list(specs):
        short = name.split(".", 2)[-1] if name.startswith("layers.") else ""
        if short in ("wq", "wk", "wv", "wo") and not heads_split(cfg,
                                                                 tp_size):
            specs[name] = P(None, None)
        elif fsdp and short in ("moe.w_in", "moe.w_gate"):
            specs[name] = P(tp, wdp, None)
        elif fsdp and short == "moe.w_out":
            specs[name] = P(tp, None, wdp)
    return specs
