"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01; unverified]
Dense GQA decoder: 64L, d_model 12288, 96 heads (kv=8), d_ff 33792,
vocab 256000, no biases."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv=8, d_head=128,
    d_ff=33792, vocab=256000, activation="silu", gated=True,
    dtype="bfloat16", attention_impl="chunked", q_chunk=512, kv_chunk=1024,
)

FAMILY = "lm"
