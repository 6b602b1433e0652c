"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf]
Llama-arch small model: 30L, d_model 576, 9 heads (kv=3), d_ff 1536,
vocab 49152."""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_head=64,
    d_ff=1536, vocab=49152, activation="silu", gated=True,
    dtype="bfloat16", attention_impl="chunked", q_chunk=512, kv_chunk=1024,
)

FAMILY = "lm"
