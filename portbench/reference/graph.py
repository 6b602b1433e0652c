"""Plain references of the graph queries: PageRank power iteration,
Bellman-Ford shortest paths and BFS levels, over an edge list.

Plain PyTorch (`index_add_`, `scatter_reduce_`, elementwise), on whatever
device the edges are handed on.  Nothing here imports the port, JAX or the
JAX package: what the port's ingress derives (dst order, out-degrees, CSR)
is not used; out-degrees are counted here again from the edge list.
`dtype` is the arithmetic's type: float64 for the reference, bfloat16 for
the control that stands below the port's float32.
"""
from __future__ import annotations

import math

import torch

# device memory a block of Bellman-Ford's roots may take at most: a root
# takes up to `EDGE_BYTES` an edge in a round (its mask over the edges,
# and, were every edge relaxed at once, their indices and candidates)
BLOCK_BYTES = 32 << 30
EDGE_BYTES = 48


def out_degrees(src: torch.Tensor, num_vertices: int) -> torch.Tensor:
    return torch.bincount(src, minlength=num_vertices)


def pagerank(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
             iterations: int, damping: float,
             dtype=torch.float64) -> torch.Tensor:
    """GRE's PageRank (paper Eq. 6): `pr_0 = 1`; each iteration
    `pr[v] = (1 - d) + d * sum over u->v of pr[u] / outdeg(u)`, with
    out-degree 0 counted as 1.  Returns `[V]` in `dtype`."""
    deg = out_degrees(src, num_vertices).clamp(min=1).to(dtype)
    pr = torch.ones(num_vertices, dtype=dtype, device=src.device)
    for _ in range(iterations):
        acc = torch.zeros(num_vertices, dtype=dtype, device=src.device)
        acc.index_add_(0, dst, (pr / deg).index_select(0, src))
        pr = (1.0 - damping) + damping * acc
    return pr


def shortest_paths(src: torch.Tensor, dst: torch.Tensor,
                   weight: torch.Tensor, num_vertices: int, roots,
                   dtype=torch.float64) -> torch.Tensor:
    """Bellman-Ford from each of `roots`: `[V, R]` distances in `dtype`,
    inf where unreached.  `weight` None gives BFS levels.  The roots go
    in blocks of at most `BLOCK_BYTES` each."""
    roots = [int(r) for r in roots]
    block = max(1, BLOCK_BYTES // max(src.shape[0] * EDGE_BYTES, 1))
    cols = [_bellman_ford(src, dst, weight, num_vertices, roots[i:i + block],
                          dtype)
            for i in range(0, len(roots), block)]
    return torch.cat(cols, dim=1)


def _bellman_ford(src, dst, weight, num_vertices, roots, dtype):
    """Label-correcting Bellman-Ford for a block of roots at once: each
    round relaxes the out-edges of the (vertex, root) pairs whose distance
    fell in the round before, until none fell.  The same distances as
    relaxing every edge each round, in fewer relaxations."""
    r = len(roots)
    dev = src.device
    dist = torch.full((num_vertices, r), math.inf, dtype=dtype, device=dev)
    start = (torch.as_tensor(roots, dtype=torch.int64, device=dev),
             torch.arange(r, device=dev))
    dist[start] = 0.0
    fell = torch.zeros((num_vertices, r), dtype=torch.bool, device=dev)
    fell[start] = True
    while True:
        edge, col = torch.nonzero(fell.index_select(0, src), as_tuple=True)
        if edge.numel() == 0:
            return dist
        cand = dist[src[edge], col]
        cand += 1.0 if weight is None else weight[edge].to(dtype)
        new = dist.clone()
        new.view(-1).scatter_reduce_(0, dst[edge] * r + col, cand,
                                     reduce="amin")
        del edge, col, cand
        fell = new < dist
        dist = new
