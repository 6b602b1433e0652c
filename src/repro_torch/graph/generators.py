"""Synthetic graph generators (numpy, host-side).

The paper evaluates on R-MAT graphs "generated using Graph500 benchmark with
parameters a=0.57, b=c=0.19, d=0.05 ... fixed out-degree 16" (§7).  Each
generator makes the same numpy RNG calls as its counterpart in the JAX
package, so a seed gives byte-identical graphs in both.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structures import Graph

GRAPH500_A, GRAPH500_B, GRAPH500_C = 0.57, 0.19, 0.19


def rmat_edges(scale: int, edge_factor: int = 16, a: float = GRAPH500_A,
               b: float = GRAPH500_B, c: float = GRAPH500_C,
               seed: int = 0, weights: bool = False,
               permute: bool = True) -> Graph:
    """Graph500-style R-MAT generator: 2**scale vertices, edge_factor*V edges.

    Edge weights (when requested) are integers sampled from [1, 65535],
    matching the paper's SSSP setup (§7.1.1).
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        src_bit = (r >= ab).astype(np.int64)
        # within the chosen half, pick the column quadrant
        r2 = rng.random(m)
        thr = np.where(src_bit == 0, a / ab, c / (1.0 - ab))
        dst_bit = (r2 >= thr).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    if permute:
        perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    props = {}
    if weights:
        props["weight"] = rng.integers(1, 65536, size=m).astype(np.float32)
    return Graph(n, src, dst, props)


def circulant_graph(n: int, degree: int = 16, weights: bool = False,
                    seed: int = 0) -> Graph:
    """Each vertex connects to its next `degree` neighbors mod n: the
    sparse-frontier stress case (a BFS frontier never exceeds `degree`)."""
    src = np.repeat(np.arange(n, dtype=np.int64), degree)
    dst = (src + np.tile(np.arange(1, degree + 1, dtype=np.int64), n)) % n
    props = {}
    if weights:
        rng = np.random.default_rng(seed)
        props["weight"] = rng.integers(1, 16, size=n * degree).astype(np.float32)
    return Graph(n, src, dst, props)


def barabasi_albert_graph(n: int, m: int = 8, seed: int = 0,
                          weights: bool = False) -> Graph:
    """Preferential-attachment power-law graph (Barabási–Albert), every
    edge emitted in both directions: hubs of degree O(m·√n)."""
    rng = np.random.default_rng(seed)
    rep = np.empty(2 * n * m, dtype=np.int64)   # flat endpoint list
    ptr = 0
    srcs, dsts = [], []
    for v in range(m, n):
        if ptr == 0:
            tgts = np.arange(min(v, m), dtype=np.int64)
        else:
            tgts = np.unique(rep[rng.integers(0, ptr, size=m)])
        k = tgts.shape[0]
        srcs.append(np.full(k, v, dtype=np.int64))
        dsts.append(tgts)
        rep[ptr:ptr + k] = tgts
        rep[ptr + k:ptr + 2 * k] = v
        ptr += 2 * k
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    e = 2 * src.shape[0]
    props = {}
    if weights:
        props["weight"] = rng.integers(1, 16, size=e).astype(np.float32)
    return Graph(n, np.concatenate([src, dst]), np.concatenate([dst, src]),
                 props)


def ring_graph(n: int, weights: bool = False) -> Graph:
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    props = {"weight": np.ones(n, dtype=np.float32)} if weights else {}
    return Graph(n, src, dst, props)


def grid_graph(rows: int, cols: int) -> Graph:
    """4-neighbor grid, directed both ways."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    s, d = [], []
    s.append(idx[:, :-1].ravel())
    d.append(idx[:, 1:].ravel())
    s.append(idx[:-1, :].ravel())
    d.append(idx[1:, :].ravel())
    src = np.concatenate(s + d)
    dst = np.concatenate(d + s)
    return Graph(rows * cols, src, dst)


def erdos_renyi_edges(n: int, m: int, seed: int = 0,
                      weights: bool = False) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    props = {}
    if weights:
        props["weight"] = rng.integers(1, 65536, size=m).astype(np.float32)
    return Graph(n, src, dst, props)
