"""Graph500 R-MAT on the card: the graph and its search keys.

The semantics of `repro_torch.graph.generators.rmat_edges(scale,
edge_factor, weights=True).dedup()` (Graph500 a=0.57, b=c=0.19, GRE paper
§7): `2**scale` vertices, `edge_factor * 2**scale` edges drawn bit by bit,
integer weights in [1, 65535] (§7.1.1), the vertex ids permuted, then self
loops and duplicate (src, dst) pairs removed, the first drawn of each pair
kept, the edges left in (src, dst) order.  Graph500's search keys are
`search_keys` distinct vertices of out-degree >= 1.

The edges, their weights and the keys are drawn from the configuration's
`structure_seed`; `--seed` draws the vertex permutation.  So every seed
gets the same graph up to its vertex labels (and so its memory layout and
edge order), with the same keys relabelled: the same work in another
order.  The draws come from `torch.Generator`s on the device, a few large
calls a bit (not the numpy stream of the port's host generator).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class EdgeList:
    """A directed weighted graph as host arrays, the one both sides read:
    `src`, `dst` int64 and `weight` float32, each `[E]`, in (src, dst)
    order."""

    num_vertices: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def rmat_draw(scale: int, edge_factor: int, a: float, b: float, c: float,
              weight_range: tuple, gen: torch.Generator, device) -> tuple:
    """Device tensors `(src, dst, weight)` of the R-MAT draw, unpermuted,
    with its self loops and duplicates."""
    m = (1 << scale) * edge_factor
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    ab = a + b
    for bit in range(scale):
        src_bit = torch.rand(m, generator=gen, device=device) >= ab
        # within the chosen half, the column quadrant
        thr = torch.where(src_bit, c / (1.0 - ab), a / ab)
        dst_bit = torch.rand(m, generator=gen, device=device) >= thr
        src |= src_bit.to(torch.int64) << bit
        dst |= dst_bit.to(torch.int64) << bit
        del src_bit, dst_bit, thr
    lo, hi = weight_range
    weight = torch.randint(lo, hi + 1, (m,), generator=gen,
                           device=device).to(torch.float32)
    return src, dst, weight


def dedup(src, dst, weight, num_vertices: int) -> tuple:
    """Drop self loops and repeated (src, dst) pairs, keeping the first
    drawn of each; the result is in (src, dst) order."""
    keep = torch.nonzero(src != dst).squeeze(1)
    key = src[keep] * num_vertices + dst[keep]
    key, order = torch.sort(key, stable=True)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    sel = keep[order[first]]
    return src[sel], dst[sel], weight[sel]


def search_keys(src: torch.Tensor, num_vertices: int, count: int,
                gen: torch.Generator) -> torch.Tensor:
    """`count` distinct vertices of out-degree >= 1, drawn uniformly."""
    deg = torch.bincount(src, minlength=num_vertices)
    cands = torch.nonzero(deg > 0).squeeze(1)
    pick = torch.randperm(cands.shape[0], generator=gen,
                          device=cands.device)[:count]
    return cands[pick]


def make_graph(cfg: dict, seed: int, device) -> tuple:
    """`(EdgeList, search keys)` of the configuration's `graph` for
    `--seed`, as host arrays; the device buffers are freed first."""
    n = 1 << cfg["scale"]
    gen = generator(cfg["structure_seed"], device)
    src, dst, weight = rmat_draw(cfg["scale"], cfg["edge_factor"], cfg["a"],
                                 cfg["b"], cfg["c"],
                                 tuple(cfg["weight_range"]), gen, device)
    src, dst, weight = dedup(src, dst, weight, n)
    keys = search_keys(src, n, cfg["search_keys"], gen)
    perm = torch.randperm(n, generator=generator(seed, device), device=device)
    src, dst, keys = perm[src], perm[dst], perm[keys]
    # back to (src, dst) order under the new labels
    src, dst, weight = dedup(src, dst, weight, n)
    edges = EdgeList(n, src.cpu().numpy(), dst.cpu().numpy(),
                     weight.cpu().numpy())
    keys = keys.cpu().numpy()
    del src, dst, weight
    return edges, keys
