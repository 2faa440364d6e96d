"""internvl2-1b — InternVL2-1B LM backbone (Qwen2-0.5B-class decoder).
[arXiv:2404.16821; hf]
24L d_model=896 14H (GQA kv=2, head_dim=64) d_ff=4864 vocab=151655.
The InternViT frontend is a STUB per the assignment: input_specs()
supplies 256 precomputed patch embeddings (prefix_len=256)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    tie_embeddings=True,
    prefix_len=256,
    activation="swiglu",
    sharding_overrides=(("seq", "model"),),
)
