"""Workload configuration dataclasses of the port (graph family only)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphWorkloadConfig:
    """The paper's own workload family: vertex programs on R-MAT graphs."""
    name: str
    algorithm: str       # pagerank | sssp | cc | bfs
    scale: int           # log2 |V| (Graph500)
    edge_factor: int = 16
    max_steps: int = 30
    exchange: str = "agent"
