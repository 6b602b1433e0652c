"""The paper's own workloads: PageRank / SSSP / CC on Graph500 R-MAT graphs
(§7: a=0.57, b=c=0.19, edge factor 16)."""
from repro_torch.configs.base import GraphWorkloadConfig

PAGERANK = GraphWorkloadConfig("gre-pagerank", "pagerank", scale=14,
                               max_steps=30)
SSSP = GraphWorkloadConfig("gre-sssp", "sssp", scale=14, max_steps=100)
CC = GraphWorkloadConfig("gre-cc", "cc", scale=14, max_steps=100)

FAMILY = "graph"
