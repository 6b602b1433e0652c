"""mace [arXiv:2206.07697; paper]
Higher-order E(3)-equivariant message passing: 2 layers, d_hidden 128,
l_max 2, correlation order 3, 8 radial Bessel functions."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="mace", family="mace", n_layers=2, d_hidden=128,
    l_max=2, correlation_order=3, n_rbf=8, d_out=1,
)

FAMILY = "gnn"
