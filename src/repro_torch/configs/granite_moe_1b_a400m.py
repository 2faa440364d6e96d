"""granite-moe-1b-a400m — IBM Granite 3.0 1B-A400M base.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE 32 experts top-8,
expert d_ff=512 (SwiGLU)."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,  # all FFN capacity lives in the experts
    vocab_size=49155,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512),
    tie_embeddings=True,
    activation="swiglu",
)
