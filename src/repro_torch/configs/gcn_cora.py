"""gcn-cora [arXiv:1609.02907; paper]
2-layer GCN, d_hidden 16, mean/sym-norm aggregation."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora", family="gcn", n_layers=2, d_hidden=16,
    aggregator="mean", norm="sym", n_classes=7,
)

FAMILY = "gnn"
