"""granite-20b — IBM Granite 20B code model. [arXiv:2405.04324; hf]
52L d_model=6144 48H (MQA kv=1, head_dim=128) d_ff=24576 vocab=49152.
GPT-BigCode lineage: MQA + plain GELU MLP (d_ff = 4*d_model)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",
    train_microbatches=16,
)
