"""Fanout neighbor sampling for minibatch GNN training (GraphSAGE-style).

The port's copy of `repro.graph.sampler` (host numpy code): for the same
graph, fanout and `(seed, step, rank)` every array it returns is
byte-equal to the JAX package's.

The `minibatch_lg` shape (232,965 nodes / 114.6M edges, 1024 seeds, fanout
15-10) trains on sampled subgraphs; this sampler produces them with static
padded shapes:

  * per hop h, every frontier node draws ≤ fanout[h] in-neighbors uniformly
    without replacement (CSR row slices);
  * the union of sampled nodes is compacted to local ids; edges are emitted
    dst-sorted (the combine key), padded to the static budget
    seeds·(f1 + f1·f2), with node budget seeds·(1 + f1 + f1·f2);
  * deterministic from (seed, step, rank) — the same coordination-free
    restart contract as the token pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.graph.structures import CSR, Graph, coo_to_csr


@dataclasses.dataclass
class SampledSubgraph:
    """Padded, locally-renumbered subgraph (numpy, ready for device)."""
    node_ids: np.ndarray    # [n_pad] global ids (-1 padding)
    src: np.ndarray         # [e_pad] local ids
    dst: np.ndarray         # [e_pad] local ids
    edge_mask: np.ndarray   # [e_pad]
    seed_mask: np.ndarray   # [n_pad] True on the seed nodes (loss targets)
    num_nodes: int
    num_edges: int


class NeighborSampler:
    def __init__(self, graph: Graph, fanout: Sequence[int], seed: int = 0):
        self.graph = graph
        self.fanout = tuple(fanout)
        self.seed = seed
        # in-adjacency: sample the neighbors that MESSAGE INTO a node
        self.csr: CSR = coo_to_csr(graph.src, graph.dst, graph.num_vertices,
                                   by="dst")

    def budget(self, n_seeds: int) -> Tuple[int, int]:
        n, e, layer = 1, 0, 1
        for f in self.fanout:
            layer *= f
            n += layer
            e += layer
        return n_seeds * n, n_seeds * e

    def sample(self, n_seeds: int, step: int, rank: int = 0
               ) -> SampledSubgraph:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, rank]))
        n_pad, e_pad = self.budget(n_seeds)
        seeds = rng.choice(self.graph.num_vertices, size=n_seeds,
                           replace=False)
        frontier = seeds
        edges_s, edges_d = [], []
        all_nodes = [seeds]
        for f in self.fanout:
            starts = self.csr.indptr[frontier]
            degs = self.csr.indptr[frontier + 1] - starts
            # uniform without replacement via per-node random offsets
            take = np.minimum(degs, f)
            next_nodes = []
            for v, st, dg, tk in zip(frontier, starts, degs, take):
                if tk == 0:
                    continue
                picks = (rng.permutation(dg)[:tk] if dg > f
                         else np.arange(dg))
                nbrs = self.csr.indices[st + picks]
                edges_s.append(nbrs)
                edges_d.append(np.full(len(nbrs), v))
                next_nodes.append(nbrs)
            frontier = (np.unique(np.concatenate(next_nodes))
                        if next_nodes else np.empty(0, np.int64))
            all_nodes.append(frontier)

        nodes = np.unique(np.concatenate(all_nodes))
        src_g = (np.concatenate(edges_s) if edges_s
                 else np.empty(0, np.int64))
        dst_g = (np.concatenate(edges_d) if edges_d
                 else np.empty(0, np.int64))
        # compact to local ids (`nodes` is sorted and unique, so a binary
        # search gives each global id's position), dst-sorted edges
        src_l = np.searchsorted(nodes, src_g).astype(np.int32)
        dst_l = np.searchsorted(nodes, dst_g).astype(np.int32)
        order = np.argsort(dst_l, kind="stable")
        src_l, dst_l = src_l[order], dst_l[order]

        n, e = len(nodes), len(src_l)
        if n > n_pad or e > e_pad:
            raise ValueError(f"sample outgrew its budget: {n} > {n_pad} "
                             f"nodes or {e} > {e_pad} edges")
        out_nodes = np.full(n_pad, -1, np.int64)
        out_nodes[:n] = nodes
        out_src = np.full(e_pad, n_pad - 1, np.int32)
        out_dst = np.full(e_pad, n_pad - 1, np.int32)
        out_src[:e], out_dst[:e] = src_l, dst_l
        mask = np.zeros(e_pad, bool)
        mask[:e] = True
        seed_mask = np.zeros(n_pad, bool)
        seed_mask[:n] = np.isin(nodes, seeds)
        return SampledSubgraph(out_nodes, out_src, out_dst, mask, seed_mask,
                               n, e)

    def batch(self, n_seeds: int, step: int, world: int
              ) -> Dict[str, np.ndarray]:
        """One stacked data-parallel batch: `world` independent subgraphs."""
        subs = [self.sample(n_seeds, step, rank) for rank in range(world)]
        return {
            "node_ids": np.stack([s.node_ids for s in subs]),
            "src": np.stack([s.src for s in subs]),
            "dst": np.stack([s.dst for s in subs]),
            "edge_mask": np.stack([s.edge_mask for s in subs]),
            "seed_mask": np.stack([s.seed_mask for s in subs]),
        }
