"""`GraphQueryBatcher` over a `torch.distributed` world: one Agent-Graph
shard a process (`ProcessGroupComm`), 4 gloo ranks on the CPU, against the
port's own batcher over the same k = 4 shards stacked in one process
(`StackedComm`).  The JAX package's distributed admission fails under its
JAX version (ROADMAP Queue 3), so the stacked port is the reference.

BFS, SSSP and PPR batchers of 4 lanes (`torch_dist_cases.serving_case`):
ten queries through recycled lanes with one budget eviction, then a churn
delta landing under "finish" while queries are resident, and queries on
the mutated graph.  Every rank's every answer, status and superstep count
equals the stacked batcher's bitwise (PPR included: the ranks fold each
sum in the stacked order).
"""
import numpy as np
import pytest

from repro_torch.dist.comm import StackedComm
from repro_torch.dist.world import run_world

import torch_dist_cases as cases
from torch_parity import JAX_K

WORLD_TIMEOUT = 240.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """`(ranks, stacked)`: each rank's served queries and the stacked
    batcher's."""
    ags, delta, _ = cases.inputs()
    out = tmp_path_factory.mktemp("serving_ranks")
    done = run_world(cases.serving_rank_main, JAX_K, (ags, delta, str(out)),
                     device="cpu", timeout=WORLD_TIMEOUT)
    assert [r.value for r in done] == list(range(JAX_K))
    ranks = []
    for r in range(JAX_K):
        with np.load(out / f"rank{r}.npz") as z:
            ranks.append(dict(z))
    return ranks, cases.serving_cases(ags, delta, StackedComm(JAX_K))


@pytest.mark.parametrize("kind", cases.SERVE_KINDS)
def test_rank_batcher_matches_stacked(world, kind):
    ranks, stacked = world
    keys = sorted(f for f in stacked if f.startswith(f"{kind}/"))
    n = len(cases.SERVE_FIRST) + len(cases.SERVE_SECOND)
    statuses = [str(stacked[f"{kind}/{u}/status"]) for u in range(n)]
    # every query finished; lanes recycled, one evicted
    assert statuses.count("evicted") == 1 and statuses[2] == "evicted"
    assert statuses.count("done") == n - 1 > cases.SERVE_LANES
    for r, got in enumerate(ranks):
        assert sorted(f for f in got if f.startswith(f"{kind}/")) == keys
        for f in keys:
            if f.endswith("/host_reads"):
                continue
            assert got[f].dtype == stacked[f].dtype, f
            np.testing.assert_array_equal(got[f], stacked[f],
                                          err_msg=f"rank {r} {f}")


def test_delta_changed_the_answers(world):
    """The second wave ran on the mutated graph: some BFS answer after the
    delta differs from the same source's answer on the unchanged graph."""
    from repro_torch.core import algorithms
    from repro_torch.core.dist_engine import DistGREEngine
    ags, _, _ = cases.inputs()
    _, stacked = world
    eng = DistGREEngine(algorithms.bfs_program(), JAX_K, device="cpu")
    first = len(cases.SERVE_FIRST)
    changed = 0
    for i, s in enumerate(cases.SERVE_SECOND):
        old, _ = eng.run(ags[False], source=s, max_steps=300)
        changed += not np.array_equal(
            stacked[f"bfs/{first + i}/result"][:, 0]
            if stacked[f"bfs/{first + i}/result"].ndim == 2
            else stacked[f"bfs/{first + i}/result"], old)
    assert changed > 0
