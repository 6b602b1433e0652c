"""nemotron-4-15b [arXiv:2402.16819; unverified]
Dense GQA decoder with squared-ReLU MLP (no gating): 32L, d_model 6144,
48 heads (kv=8), d_ff 24576, vocab 256000."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-15b",
    n_layers=32, d_model=6144, n_heads=48, n_kv=8, d_head=128,
    d_ff=24576, vocab=256000, activation="squared_relu", gated=False,
    dtype="bfloat16", attention_impl="chunked", q_chunk=512, kv_chunk=1024,
)

FAMILY = "lm"
