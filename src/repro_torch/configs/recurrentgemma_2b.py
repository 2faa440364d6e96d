"""recurrentgemma-2b — Griffin-style hybrid. [arXiv:2402.19427; hf]
26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
Pattern (RG-LRU, RG-LRU, local-attn) tiled over 26 layers; local
attention window 2048; GeGLU MLP; lru_width=2560.
Sub-quadratic decode state (LRU state + 2048-window KV) => long_500k runs."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    lru_width=2560,
    tie_embeddings=True,
    activation="geglu",
    sharding_overrides=(("seq", "model"),),
)
