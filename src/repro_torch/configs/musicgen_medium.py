"""musicgen-medium — MusicGen decoder over EnCodec tokens.
[arXiv:2306.05284; hf]
48L d_model=1536 24H (MHA kv=24, head_dim=64) d_ff=6144 vocab=2048.
The EnCodec frontend is a STUB per the assignment: input_specs()
supplies 64 precomputed conditioning frame embeddings (prefix_len=64).
GELU MLP; RoPE replaces the original sinusoidal embedding (TPU-idiomatic
choice recorded in DESIGN.md)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    prefix_len=64,
    activation="gelu",
    sharding_overrides=(("seq", "model"),),
)
