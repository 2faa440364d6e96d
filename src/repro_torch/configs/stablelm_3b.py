"""stablelm-3b — StableLM family dense decoder.
[hf:stabilityai/stablelm-2-1_6b; unverified — assigned shape is the 3B row]
32L d_model=2560 32H (MHA kv=32, head_dim=80) d_ff=6912 vocab=50304."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    activation="swiglu",
    sharding_overrides=(("seq_cache", None),),
)
