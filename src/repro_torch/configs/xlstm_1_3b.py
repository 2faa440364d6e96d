"""xlstm-1.3b — xLSTM language model. [arXiv:2405.04517; unverified]
48 blocks d_model=2048, 4 heads, vocab=50304, d_ff=0 (per assignment).
Block pattern: 7 mLSTM (matrix memory, parallel quadratic form for
training, O(1) recurrent state for decode) : 1 sLSTM (scalar memory,
block-diagonal recurrence) -> sub-quadratic, long_500k applicable."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    sharding_overrides=(("head_dim", "model"),),
)
