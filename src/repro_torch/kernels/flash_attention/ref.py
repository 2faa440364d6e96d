"""Plain PyTorch oracle for the flash-attention kernels (fp32 math)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  kv_lens: Optional[Sequence[int]] = None):
    """q, k, v: (bh, s, hd) -> (bh, s, hd), fp32 math.

    ``kv_lens`` (per-lane valid KV lengths, shape (bh,)) masks columns at
    or beyond each lane's length — the ragged-decode oracle for the
    schedule-aware kernel.  Rows with every column masked return 0.
    """
    bh, s, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bsd,btd->bst", q.float(), k.float()) * scale
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    mask = mask[None].expand(bh, s, s)
    if kv_lens is not None:
        lens = torch.as_tensor(np.asarray(kv_lens, np.int64), device=q.device)
        mask = mask & (i[None, None, :] < lens[:, None, None])
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (ragged padding): uniform softmax garbage -> 0
    alive = mask.any(dim=-1, keepdim=True)
    probs = torch.where(alive, probs, 0.0)
    out = torch.einsum("bst,btd->bsd", probs, v.float())
    return out.to(q.dtype)
