"""qwen3-moe-30b-a3b — Qwen3-30B-A3B. [hf:Qwen/Qwen3-30B-A3B; hf]
48L d_model=2048 32H (GQA kv=4, head_dim=128, qk-norm) vocab=151936,
MoE 128 experts top-8, expert d_ff=768 (SwiGLU).
This is the paper-representative MoE cell for the DLS expert balancer."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff=768),
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    train_microbatches=8,
)
