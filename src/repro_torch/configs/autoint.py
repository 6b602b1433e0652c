"""autoint [arXiv:1810.11921; paper]
Self-attention feature interaction: 39 sparse fields, embed 16, 3 attention
layers (2 heads, d_attn 32).  Criteo-like long-tail vocab (~37M total rows)."""
from repro_torch.configs.base import RecSysConfig

VOCABS = tuple([10_000_000] * 3 + [1_000_000] * 6 + [100_000] * 10
               + [1_000] * 20)
assert len(VOCABS) == 39

CONFIG = RecSysConfig(
    name="autoint", n_sparse=39, embed_dim=16, n_attn_layers=3,
    n_heads=2, d_attn=32, vocab_sizes=VOCABS,
)

FAMILY = "recsys"
