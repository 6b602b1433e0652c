"""MACE-style higher-order equivariant message passing (arXiv:2206.07697),
the counterpart of `repro/models/mace.py`.

Structure per layer (2 layers, l_max=2, correlation order 3):

  1. edge attrs: real spherical harmonics Y_l(r̂) and Bessel radial basis;
  2. A-features: for every coupling path (l_in ⊗ l_edge → l_out), messages
     m = CG(h[src], Y) · R(d) are summed to nodes — the GRE active-message
     primitive with irrep-vector payloads `[E, ch, 2l+1]`, which the
     combine kernel takes flattened (D = ch·(2l+1));
  3. higher-order B-features: iterated CG products A⊗A → B, B⊗A → C
     (correlation order 3), linearly mixed per path;
  4. update: linear mix per l, residual; readout from l=0 channels.

The node gathers `h[src]` are `kernels.ops.gather_rows` and the default
aggregation `kernels.ops.route_sum`, both over routes built once
(`MaceRoutes`), so each forward sum and each gather's backward is one
combine launch.  CG tensors come from `repro_torch.nn.equivariant`
(numerically projected, convention-free, bitwise the JAX package's).
Positions and species are data.  Entry points build on CUDA unless the
caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.gnn import _leaf, _map, leaves_from_numpy
from repro_torch.nn.equivariant import (bessel_basis, cg_tensor,
                                        cosine_cutoff, real_sh, valid_paths)
from repro_torch.nn.layers import dense_init, mlp_apply, mlp_init

CUTOFF = 5.0


def init_mace(generator: torch.Generator, cfg: GNNConfig,
              n_species: int = 16, d_out: int = 1, device="cuda"):
    """Random parameters drawn from `generator` (on `device`) with the JAX
    package's tree (int-keyed dicts per l), shapes and scales: leaf
    tensors that require gradients."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    lm, ch = cfg.l_max, cfg.d_hidden
    paths = valid_paths(lm)
    params: Dict = {
        "embed": torch.randn((n_species, ch), generator=generator,
                             device=dev) * 0.5,
        "layers": [],
        "readout": mlp_init(generator, [ch, ch, d_out]),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            # radial MLP: bessel -> weights per path per channel
            "radial": mlp_init(generator, [cfg.n_rbf, 32, len(paths) * ch]),
            # linear mixes per output l, applied after aggregation
            **{name: {l: dense_init(generator, ch, ch)
                      for l in range(lm + 1)}
               for name in ("mix_A", "mix_B", "mix_C", "self")},
        })
    return _map(_leaf, params)


def params_from_numpy(tree, cfg: GNNConfig, device="cuda"):
    """The JAX package's `init_mace` parameters, as numpy arrays in its
    tree, as the port's tree of float32 leaf tensors on `device`."""
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, config "
                         f"{cfg.n_layers}")
    return leaves_from_numpy(tree, device)


def _cg_apply(u: torch.Tensor, v: torch.Tensor, l1: int, l2: int, l3: int
              ) -> torch.Tensor:
    """u: [N, ch, 2l1+1], v: [N, (ch,) 2l2+1] → [N, ch, 2l3+1]."""
    C = torch.from_numpy(cg_tensor(l1, l2, l3)).to(u.device, u.dtype)
    if v.dim() == u.dim():        # channel-wise product
        return torch.einsum("kij,nci,ncj->nck", C, u, v)
    return torch.einsum("kij,nci,nj->nck", C, u, v)


@dataclasses.dataclass
class MaceRoutes:
    """The routes of one graph, built once: the `h[src]` gathers'
    backward (over the nodes), the species embedding's, and the default
    aggregation's (edges with `dst < V`, in dst order)."""

    src: ops.GatherRoute
    species: ops.GatherRoute
    dst: ops.GatherRoute

    @staticmethod
    def build(species, src, dst, num_nodes: int,
              n_species: int) -> "MaceRoutes":
        return MaceRoutes(
            src=ops.GatherRoute.build(src, num_nodes),
            species=ops.GatherRoute.build(species, n_species),
            dst=ops.GatherRoute.build(dst, num_nodes,
                                      mask=dst.long() < num_nodes))


def mace_forward(params, pos: torch.Tensor, species: torch.Tensor,
                 src: torch.Tensor, dst: torch.Tensor,
                 edge_mask: torch.Tensor, cfg: GNNConfig, prop_fn=None,
                 routes: Optional[MaceRoutes] = None) -> torch.Tensor:
    """pos [V,3], species [V] int, COO edges.  Returns per-node scalar
    outputs [V, d_out] (sum for a graph energy).

    `prop_fn(msgs [E, ch, m], dst) -> [V, ch, m]` abstracts local vs
    agent-sharded aggregation; the default sums over `routes.dst`.  Each
    layer and each path's messages run under `torch.utils.checkpoint`, as
    the JAX package's `jax.checkpoint`s: one path's `[E, ch, m]` lives at
    a time, and the backward recomputes them.
    """
    V = pos.shape[0]
    lm, ch = cfg.l_max, cfg.d_hidden
    paths = valid_paths(lm)
    if routes is None:
        routes = MaceRoutes.build(species, src, dst, V,
                                  params["embed"].shape[0])
    if prop_fn is None:
        def prop_fn(msgs, dst_):
            return ops.route_sum(msgs, routes.dst)

    src_l = src.long()
    vec = pos.index_select(0, dst.long()) - pos.index_select(0, src_l)
    d = torch.linalg.norm(vec, dim=-1)
    rhat = vec / torch.clamp(d, min=1e-6)[:, None]
    Y = real_sh(rhat, lm)                          # l -> [E, 2l+1]
    rbf = bessel_basis(d, cfg.n_rbf, CUTOFF) * cosine_cutoff(d, CUTOFF)[:, None]
    emask = edge_mask.to(pos.dtype)

    # node features: l -> [V, ch, 2l+1]; start with the species embedding
    h = {l: torch.zeros((V, ch, 2 * l + 1), dtype=pos.dtype,
                        device=pos.device) for l in range(lm + 1)}
    h[0] = ops.gather_rows(params["embed"], species.long(),
                           routes.species)[:, :, None]

    def path_msg(l1, l2, l3, h_l1, rw):
        m = _cg_apply(ops.gather_rows(h_l1, src_l, routes.src), Y[l2],
                      l1, l2, l3)
        m = m * (rw * emask[:, None])[:, :, None]
        return prop_fn(m, dst)

    def mix(x, w):
        return torch.einsum("ncm,cd->ndm", x, w)

    def one_layer(h, lp):
        Rw = mlp_apply(lp["radial"], rbf).reshape(-1, len(paths), ch)
        # --- A features: first-order sum over edges ---
        A = {l: torch.zeros((V, ch, 2 * l + 1), dtype=pos.dtype,
                            device=pos.device) for l in range(lm + 1)}
        for pi, (l1, l2, l3) in enumerate(paths):
            A[l3] = A[l3] + checkpoint(path_msg, l1, l2, l3, h[l1],
                                       Rw[:, pi], use_reentrant=False)
        A = {l: mix(A[l], lp["mix_A"][l]) for l in A}
        # --- higher-order products (correlation order 3) ---
        B = {l: torch.zeros_like(A[l]) for l in A}
        for (l1, l2, l3) in paths:
            B[l3] = B[l3] + _cg_apply(A[l1], A[l2], l1, l2, l3)
        B = {l: mix(B[l], lp["mix_B"][l]) for l in B}
        Cf = {l: torch.zeros_like(A[l]) for l in A}
        for (l1, l2, l3) in paths:
            Cf[l3] = Cf[l3] + _cg_apply(B[l1], A[l2], l1, l2, l3)
        Cf = {l: mix(Cf[l], lp["mix_C"][l]) for l in Cf}
        # --- update: self-mix + message orders, residual ---
        return {l: h[l] + mix(h[l], lp["self"][l]) + A[l] + B[l] + Cf[l]
                for l in h}

    for lp in params["layers"]:
        h = checkpoint(one_layer, h, lp, use_reentrant=False)

    scalars = h[0][:, :, 0]                        # invariant channels
    return mlp_apply(params["readout"], scalars, act=F.silu)


def mace_energy(params, pos, species, src, dst, edge_mask, cfg: GNNConfig,
                routes: Optional[MaceRoutes] = None):
    return mace_forward(params, pos, species, src, dst, edge_mask, cfg,
                        routes=routes).sum()
