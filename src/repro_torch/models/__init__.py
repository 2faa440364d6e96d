"""Model zoo, ported from ``src/repro/models``: the unified decoder for all
10 architectures (attention, MoE FFN, mLSTM / sLSTM / RG-LRU blocks),
``forward``, ``decode_step`` and the training loss ``loss_fn``.
"""

from .decoder import (  # noqa: F401
    DecodeState,
    decode_step,
    forward,
    init_decode_state,
    init_decoder,
    init_decoder_axes,
    loss_fn,
)
from .attention import KVCache, init_kv_cache, kv_cache_specs  # noqa: F401
