"""Model zoo, ported from ``src/repro/models``: the unified decoder for all
10 architectures (attention, MoE FFN, mLSTM / sLSTM / RG-LRU blocks).
``loss_fn`` and remat wait for the training slice (ROADMAP.md).
"""

from .decoder import (  # noqa: F401
    DecodeState,
    decode_step,
    forward,
    init_decode_state,
    init_decoder,
)
from .attention import KVCache, init_kv_cache  # noqa: F401
