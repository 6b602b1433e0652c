"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
MoE decoder: 24L, d_model 1024, 16 heads (kv=8, d_head 64), 32 experts
top-8 with expert d_ff 512, vocab 49155."""
from repro_torch.configs.base import LMConfig, MoESpec

CONFIG = LMConfig(
    name="granite-moe-1b-a400m",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_head=64,
    d_ff=512, vocab=49155, activation="silu", gated=True,
    moe=MoESpec(n_experts=32, top_k=8, d_ff_expert=512),
    dtype="bfloat16", attention_impl="chunked", q_chunk=512, kv_chunk=1024,
    seq_shard_activations=False,
)

FAMILY = "lm"
