"""Model zoo, ported from ``src/repro/models``: the dense decoder for the
attention-only block patterns (``qwen3-4b`` and its kin).  The MoE and
recurrent blocks, ``loss_fn`` and remat wait for later slices (ROADMAP.md).
"""

from .decoder import (  # noqa: F401
    DecodeState,
    decode_step,
    forward,
    init_decode_state,
    init_decoder,
)
from .attention import KVCache, init_kv_cache  # noqa: F401
