"""gin-tu [arXiv:1810.00826; paper]
5-layer GIN, d_hidden 64, sum aggregation, learnable eps."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="gin-tu", family="gin", n_layers=5, d_hidden=64,
    aggregator="sum", eps_learnable=True, n_classes=2,
)

FAMILY = "gnn"
