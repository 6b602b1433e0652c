from repro_torch.graph.structures import Graph, pad_edges
from repro_torch.graph.generators import (circulant_graph, erdos_renyi_edges,
                                          ring_graph, rmat_edges)
