"""dimenet [arXiv:2003.03123; unverified]
Directional message passing: 6 blocks, d_hidden 128, 8 bilinear,
7 spherical, 6 radial."""
from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="dimenet", family="dimenet", n_layers=6, d_hidden=128,
    n_bilinear=8, n_spherical=7, n_radial=6, d_out=1,
)

FAMILY = "gnn"
