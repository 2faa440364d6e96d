"""Public wrapper for the flash-attention kernels (model layout).

`flash_attention` accepts model-layout tensors (b, s, h, hd) with separate
kv-head counts (GQA/MQA), as the reference's ``ops.flash_attention`` does.
The device of the inputs decides the path: a CUDA tensor launches the
kernel, a CPU tensor takes the plain PyTorch version.

Without ``schedule`` the dense kernel runs (``csrc/flash_dense.cu`` on the
card): causal and sliding-window masks, no ragged lengths.  Passing
``schedule=`` routes through the schedule-aware kernel: the (lane, q block)
group order is produced by the DLS planner and ragged per-batch KV lengths
(``kv_lens``) are supported.  On the card both kernels read the model
layout and the KV heads in place.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ...device import check_device
from .flash_attention import (flash_attention_dense_bshd,
                              flash_attention_sched_bshd)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_k: int = 512,
                    schedule: Union[str, object, None] = None,
                    kv_lens: Optional[Sequence[int]] = None,
                    sched_p: int = 8, recorder=None):
    """q: (b, s, h, hd); k, v: (b, s, kvh, hd) -> (b, s, h, hd).

    ``schedule`` (a ScheduleSpec / registry name) selects the DLS-planned
    kernel; ``kv_lens`` is a host array of per-batch valid KV lengths
    (ragged decode lanes) — columns past a lane's length are masked.
    ``sched_p`` is the planner's worker count (the kernel's CTA count on
    the card) and ``recorder`` (LoopRecorder) collects the plan's telemetry.
    """
    check_device(q, k, v)
    if schedule is None:
        if kv_lens is not None:
            raise ValueError("kv_lens requires schedule= (the DLS-planned "
                             "kernel); the dense grid has no ragged path")
        # block_q / block_k name the TPU's blocking; the result does not
        # depend on them
        return flash_attention_dense_bshd(q, k, v, causal=causal,
                                          window=window)
    lane_lens = None
    if kv_lens is not None:
        lane_lens = np.repeat(np.asarray(kv_lens, np.int64),
                              q.shape[2])  # per lane
    return flash_attention_sched_bshd(
        q, k, v, schedule=schedule, kv_lens=lane_lens, causal=causal,
        window=window, block_q=block_q, block_k=block_k, sched_p=sched_p,
        recorder=recorder)
