"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf]
MoE decoder: 48L, d_model 2048, 32 heads (kv=4, d_head 128), 128 experts
top-8 with expert d_ff 768, vocab 151936."""
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4, d_head=128,
    d_ff=768, vocab=151936, activation="silu", gated=True,
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=768),
    dtype="bfloat16", attention_impl="chunked", q_chunk=512, kv_chunk=1024,
)

FAMILY = "lm"
