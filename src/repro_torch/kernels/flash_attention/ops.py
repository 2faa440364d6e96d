"""Public wrapper for the flash-attention kernels (model layout).

`flash_attention` accepts model-layout tensors (b, s, h, hd) with separate
kv-head counts (GQA/MQA), as the reference's ``ops.flash_attention`` does.
The device of the inputs decides the path: a CUDA tensor launches the
kernel, a CPU tensor takes the plain PyTorch version.

Passing ``schedule=`` routes through the schedule-aware kernel: the
(lane, q block) group order is produced by the DLS planner, ragged
per-batch KV lengths (``kv_lens``) are supported, and on the card the
kernel reads the model layout and the KV heads in place.  Without
``schedule`` the dense kernel would run; it is not ported yet, so a CUDA
tensor raises ``NotImplementedError`` there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from ...device import check_device
from .flash_attention import broadcast_flatten, flash_attention_sched_bshd
from .ref import attention_ref


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
    dev = check_device(q, k, v)
    b, s, h, hd = q.shape
    if schedule is None:
        if kv_lens is not None:
            raise ValueError("kv_lens requires schedule= (the DLS-planned "
                             "kernel); the dense grid has no ragged path")
        if dev.type == "cuda":
            raise NotImplementedError(
                "the dense flash kernel (_flash_kernel) is not ported yet "
                "(ROADMAP.md, port queue item 1); pass schedule= to use the "
                "schedule-aware kernel")
        qf, kf, vf = broadcast_flatten(q, k, v)
        out = attention_ref(qf, kf, vf, causal=causal, window=window)
        return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)
    lane_lens = None
    if kv_lens is not None:
        lane_lens = np.repeat(np.asarray(kv_lens, np.int64), h)  # per lane
    return flash_attention_sched_bshd(
        q, k, v, schedule=schedule, kv_lens=lane_lens, causal=causal,
        window=window, block_q=block_q, block_k=block_k, sched_p=sched_p,
        recorder=recorder)
