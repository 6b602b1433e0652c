"""The plain references against small graphs worked by hand."""
import math

import torch

from portbench.reference import graph as ref

# 0 -> 1 (w 4), 0 -> 2 (w 1), 2 -> 1 (w 2), 1 -> 3 (w 5); 4 isolated
SRC = torch.tensor([0, 0, 2, 1])
DST = torch.tensor([1, 2, 1, 3])
W = torch.tensor([4.0, 1.0, 2.0, 5.0])
INF = math.inf


def test_shortest_paths_by_hand():
    d = ref.shortest_paths(SRC, DST, W, 5, [0, 2, 4])
    assert d[:, 0].tolist() == [0.0, 3.0, 1.0, 8.0, INF]
    assert d[:, 1].tolist() == [INF, 2.0, 0.0, 7.0, INF]
    assert d[:, 2].tolist() == [INF, INF, INF, INF, 0.0]


def test_bfs_levels_by_hand():
    d = ref.shortest_paths(SRC, DST, None, 5, [0])
    assert d[:, 0].tolist() == [0.0, 1.0, 1.0, 2.0, INF]


def test_pagerank_by_hand():
    # out-degrees 2, 1, 1, 0, 0; with d = 0.5 and pr_0 = 1:
    # iteration 1: pr1 = 0.5 + 0.5 * (1/2 + 1) = 1.25, pr2 = 0.75,
    #              pr3 = 0.5 + 0.5 * 1 = 1.0, pr0 = pr4 = 0.5
    pr = ref.pagerank(SRC, DST, 5, 1, 0.5)
    assert torch.allclose(pr, torch.tensor([0.5, 1.25, 0.75, 1.0, 0.5],
                                           dtype=torch.float64))
    # iteration 2: pr1 = 0.5 + 0.5 * (0.5/2 + 0.75) = 1.0,
    #              pr2 = 0.5 + 0.5 * 0.25 = 0.625, pr3 = 0.5 + 0.5 * 1.25
    pr = ref.pagerank(SRC, DST, 5, 2, 0.5)
    assert torch.allclose(pr, torch.tensor([0.5, 1.0, 0.625, 1.125, 0.5],
                                           dtype=torch.float64))


def test_bfloat16_rounds_distances():
    """The control's arithmetic: bfloat16 holds integers exactly only to
    256, so 1 + 258 comes out as 260 where float64 gives 259."""
    w = torch.tensor([300.0, 1.0, 258.0, 1.0])
    exact = ref.shortest_paths(SRC, DST, w, 5, [0])
    low = ref.shortest_paths(SRC, DST, w, 5, [0], dtype=torch.bfloat16)
    assert exact[:, 0].tolist() == [0.0, 259.0, 1.0, 260.0, INF]
    assert low[1, 0].item() != 259.0
