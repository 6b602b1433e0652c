"""PageRank job (GRE paper Eq. 6): a fixed number of supersteps from the
all-ones start, every vertex active; no search key."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import graph as ref

TAKES_ROOT = False
# the ranks' largest relative gap to the float64 reference, and its limit
# (set from the program's and the bfloat16 control's readings, PERF.md §2)
LIMITS = {"pagerank_max_rel_err": 1e-3}


def program():
    from repro_torch.core import algorithms
    return algorithms.pagerank_program()


def reference(edges, roots, params, dtype) -> torch.Tensor:
    """`[V, R]`: the same ranks for each of the R jobs."""
    pr = ref.pagerank(edges["src"], edges["dst"], edges["num_vertices"],
                      params["max_steps"], params["damping"], dtype)
    return pr[:, None].expand(-1, len(roots))


def compare(results, want: torch.Tensor, roots) -> dict:
    """The largest `|got - want| / want` over the vertices of every sampled
    job (`want` >= 1 - damping > 0)."""
    del roots
    w = want[:, 0].double().cpu().numpy()
    worst = 0.0
    for got in results:
        err = np.abs(got.astype(np.float64) - w) / w
        worst = max(worst, float(err.max()))
    return {"pagerank_max_rel_err": worst}
