"""Single-source shortest paths from a search key over the integer weights
(GRE paper Fig. 3b): distances are integers far below 2**24, exact in
float32, so the comparison is exact."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import graph as ref

TAKES_ROOT = True
LIMITS = {"sssp_wrong_vertices": 0}


def program():
    from repro_torch.core import algorithms
    return algorithms.sssp_program()


def reference(edges, roots, params, dtype) -> torch.Tensor:
    return ref.shortest_paths(edges["src"], edges["dst"], edges["weight"],
                              edges["num_vertices"], roots, dtype)


def compare(results, want: torch.Tensor, roots) -> dict:
    """Vertices, summed over the sampled queries, whose distance is not
    the reference's exactly (inf where unreached on both sides agrees)."""
    del roots
    w = want.double().cpu().numpy()
    return {"sssp_wrong_vertices": int(sum(
        np.count_nonzero(got.astype(np.float64) != w[:, i])
        for i, got in enumerate(results)))}
