"""Flash-attention forward: the dense kernel, the schedule-aware kernel,
their plans and their plain versions.

Port of ``src/repro/kernels/flash_attention/flash_attention.py``.

Dense (``flash_attention_bhsd``, the reference's ``_flash_kernel``): on a
CUDA tensor ``csrc/flash_dense.cu`` runs one CTA per (lane, 128-row q tile)
with the kv blocks as a loop inside it, skipping those above the causal
diagonal or outside the sliding window; see the note at the top of that
file.  On a CPU tensor ``flash_attention_dense_plain`` (fp32 masked
softmax) computes the same function.

Schedule-aware (``flash_attention_sched_bhsd``): the host side is kept
byte-faithful and is array arithmetic: each (lane, q block) group's live kv
blocks are one range, computed for all groups at once with its live-column
cost (``flash_kv_group_costs``); the group order is DLS-planned from those
costs (``repro_torch.core.torch_sched``); and six int32 descriptor arrays
(bi, qi, kj, first, last, lim) list the triples in plan order, expanded
with ``np.repeat`` / ``np.cumsum`` (``_plan_kv_descriptors``).  On a CUDA
tensor the descriptors, copied from pinned memory without waiting, drive
``csrc/flash_sched.cu``: a persistent TMA + wgmma kernel with ``sched_p``
CTAs, CTA ``w`` walking its plan share in order in 128-row q tiles.  On a
CPU tensor ``flash_attention_sched_plain`` computes the same function.
Outputs are bit-identical for every schedule on either path: a schedule
only permutes whole groups, and each 128-row q tile is computed inside one
CTA, its kv tiles ascending.

Both CUDA launchers read the model layout (b, s, h|kvh, hd) and the KV
heads in place through 4-D TMA tensor maps built from the strides.
``flash_dense`` takes any head dim that is a multiple of 8 up to 256 (the
configs use 64, 80, 128 and 256); ``flash_sched`` takes 64 and 128.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ...core.torch_sched import plan_tiles_for_kernel, worker_bounds
from ...device import check_device
from .._build import Kernel
from .ref import attention_ref

#: padded head dims ``flash_dense`` is instantiated for: it takes any
#: multiple of 8 up to the largest, computing at the next of these (TMA
#: fills the columns past the real head dim with zeros)
DENSE_HEAD_DIMS = (64, 128, 256)
#: head dims ``flash_sched`` is instantiated for
SCHED_HEAD_DIMS = (64, 128)

_c = ctypes
FLASH_SCHED = Kernel(
    "flash_sched", source="flash_sched", symbol="flash_sched_launch",
    argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 11 + [_c.c_longlong] * 12
    + [_c.c_float, _c.c_void_p])
FLASH_DENSE = Kernel(
    "flash_dense", source="flash_dense", symbol="flash_dense_launch",
    argtypes=[_c.c_void_p] * 4 + [_c.c_int] * 7 + [_c.c_longlong] * 12
    + [_c.c_float, _c.c_void_p])


def broadcast_flatten(q, k, v):
    """(b, s, h|kvh, hd) -> three (b*h, s, hd) lane-major tensors."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if kvh != h:
        g = h // kvh
        k = k[:, :, :, None, :].expand(b, s, kvh, g, hd).reshape(b, s, h, hd)
        v = v[:, :, :, None, :].expand(b, s, kvh, g, hd).reshape(b, s, h, hd)

    def flat(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, hd)

    return flat(q), flat(k), flat(v)


def _kv_ranges(bh: int, s: int, block_q: int, block_k: int, *,
               causal: bool, window: int, kv_lens: Optional[np.ndarray]):
    """The live kv blocks ``[lo, hi)`` of every (lane, q block) group, in
    group order (lane major), with their float64 costs and the clipped
    per-lane lengths.

    The reference walks the kv blocks of a group in order, skips those
    below the window and stops at the first one at or past the lane's
    length or above the causal diagonal.  The skipped blocks are a prefix
    and the stop holds from some block on, so the blocks it keeps are one
    range.  A group with none keeps block 0 (one step, so that its output
    is written).
    """
    nq = -(-s // block_q)
    nk = -(-s // block_k)
    lens = (np.full(bh, s, np.int64) if kv_lens is None
            else np.clip(np.asarray(kv_lens, np.int64), 0, s))
    if lens.shape != (bh,):
        raise ValueError(f"kv_lens must have shape ({bh},), got {lens.shape}")
    qi = np.arange(nq, dtype=np.int64)
    lim = lens[:, None]
    hi = np.minimum(nk, -(-lim // block_k))          # k_start >= lim: stop
    if causal:
        q_end = np.minimum((qi + 1) * block_q, s) - 1
        hi = np.minimum(hi, q_end // block_k + 1)    # above the diagonal
    hi = np.broadcast_to(hi, (bh, nq))
    lo = np.zeros_like(hi)
    if window > 0:                                   # below the window
        lo = lo + np.maximum(0, (qi * block_q - block_k + 1 - window)
                             // block_k + 1)
    dead = hi <= lo
    lo, hi = np.where(dead, 0, lo).ravel(), np.where(dead, 1, hi).ravel()
    lim = np.broadcast_to(lim, (bh, nq)).ravel()
    # full blocks but the last, cut at lim; a dead group's step costs a
    # whole block when lim is 0 (the reference's `or block_k`)
    costs = np.minimum(lim, hi * block_k) - lo * block_k
    costs = np.where(costs == 0, block_k, costs).astype(np.float64)
    return lo, hi, costs, lens


def flash_kv_group_costs(bh: int, s: int, block_q: int, block_k: int, *,
                         causal: bool = True, window: int = 0,
                         kv_lens: Optional[np.ndarray] = None):
    """Enumerate the live KV blocks per (lane, q block) group and their
    live-column costs — the cost model of the schedule-aware kernel.

    Returns (group_kjs, costs, lens): per-group ascending kv-block lists,
    the per-group cost array the DLS planner consumes, and the clipped
    per-lane lengths.
    """
    lo, hi, costs, lens = _kv_ranges(bh, s, block_q, block_k, causal=causal,
                                     window=window, kv_lens=kv_lens)
    group_kjs = [list(range(a, b)) for a, b in zip(lo.tolist(), hi.tolist())]
    return group_kjs, costs, lens


def _descriptors(order, lo, hi, lens, nq: int):
    """Six int32 arrays (bi, qi, kj, first, last, lim): the kv blocks
    ``[lo[g], hi[g])`` of every group ``g`` of ``order`` (group ``g`` is lane
    ``g // nq``, q block ``g % nq``), one descriptor each, in plan order."""
    order = np.asarray(order, np.int64)
    n = (hi - lo)[order]                     # descriptors of each group
    gid = np.repeat(order, n)
    # position of each descriptor inside its group
    j = np.arange(gid.size) - np.repeat(np.cumsum(n) - n, n)
    bi = gid // nq
    return tuple(a.astype(np.int32) for a in (
        bi, gid % nq, lo[gid] + j, j == 0, j == np.repeat(n, n) - 1,
        lens[bi]))


def _plan_kv_descriptors(bh: int, s: int, block_q: int, block_k: int, *,
                         causal: bool, window: int,
                         kv_lens: Optional[np.ndarray], schedule, p: int):
    """Host-side tile planning: enumerate live (lane, q block, kv block)
    triples, DLS-plan the q-block group order, emit descriptor arrays.

    Returns (descriptors, plan): six int32 arrays (bi, qi, kj, first,
    last, lim) of length G = total live triples, plus the KernelTilePlan
    over the (lane, q block) groups.
    """
    lo, hi, costs, lens = _kv_ranges(bh, s, block_q, block_k, causal=causal,
                                     window=window, kv_lens=kv_lens)
    plan = plan_tiles_for_kernel(costs, p=p, technique=schedule)
    return _descriptors(plan.order, lo, hi, lens, -(-s // block_q)), plan


def descriptor_bounds(desc, plan) -> np.ndarray:
    """(p + 1,) offsets into the descriptor arrays: CTA ``w`` runs
    descriptors ``[b[w], b[w+1])``, the triples of its plan share.

    Group ``i`` of the plan order starts at the i-th ``first`` flag, so a
    descriptor's worker is the ``step_worker`` of its group.
    """
    group_of = np.cumsum(desc[3], dtype=np.int64) - 1
    return worker_bounds(plan.step_worker[group_of], plan.p)


def flash_attention_sched_plain(q, k, v, *,
                                kv_lens: Optional[Sequence[int]] = None,
                                causal: bool = True, window: int = 0,
                                lane_chunk: int = 32):
    """The plain PyTorch version of the kernel: q, k, v (bh, s, hd) ->
    (bh, s, hd), fp32 masked softmax, dead rows 0, on any device.

    Lanes are taken ``lane_chunk`` at a time so the fp32 (lanes, s, s)
    scores stay bounded at long sequence lengths.
    """
    bh = q.shape[0]
    lens = None if kv_lens is None else np.asarray(kv_lens, np.int64)
    outs = []
    for a in range(0, bh, lane_chunk):
        z = slice(a, min(a + lane_chunk, bh))
        outs.append(attention_ref(q[z], k[z], v[z], causal=causal,
                                  window=window,
                                  kv_lens=None if lens is None else lens[z]))
    return torch.cat(outs, dim=0)


def _check_kernel_inputs(name: str, q, k, v) -> None:
    """Raise unless q (b, s, h, hd), k/v (b, s, kvh, hd) are what the CUDA
    kernel ``name`` takes: a GQA layout, bfloat16, a head dim it is built
    for, a contiguous last dim, 16-byte aligned rows."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape != (b, s, kvh, hd) or v.shape != k.shape or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not form a GQA layout")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes bfloat16 q, k and v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    # flash_dense: multiples of 8 (16-byte rows for TMA) up to its widest
    # padded instantiation
    if name == "flash_dense" and (hd % 8 or not
                                  0 < hd <= DENSE_HEAD_DIMS[-1]):
        raise ValueError(f"flash_dense supports a head_dim that is a "
                         f"multiple of 8 up to {DENSE_HEAD_DIMS[-1]}, "
                         f"got {hd}")
    if name == "flash_sched" and hd not in SCHED_HEAD_DIMS:
        raise ValueError(f"flash_sched supports head_dim in "
                         f"{SCHED_HEAD_DIMS}, got {hd}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{nm} needs a contiguous last dim, strides "
                             f"that are multiples of 8 and 16-byte alignment")


def _strides(*tensors) -> list[int]:
    """(batch, head, row) strides of each (b, s, h, hd) tensor, in order."""
    return [t.stride(i) for t in tensors for i in (0, 2, 1)]


def _upload_table(desc, bounds, device) -> torch.Tensor:
    """The descriptors and the CTA bounds as one int32 tensor on
    ``device``, copied from pinned memory without blocking, so that the
    host does not wait for the stream to drain."""
    host = np.concatenate([*desc, np.asarray(bounds, np.int32)])
    return torch.from_numpy(host).pin_memory().to(device, non_blocking=True)


def _flash_sched_cuda(q, k, v, desc, bounds, *, block_q: int, block_k: int,
                      causal: bool, window: int):
    """Launch ``flash_sched`` on q (b, s, h, hd), k/v (b, s, kvh, hd) in
    place of their strides; returns a new (b, s, h, hd) tensor."""
    _check_kernel_inputs("flash_sched", q, k, v)
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    g = int(desc[0].shape[0])
    p = int(bounds.shape[0]) - 1
    # freed when this returns: the caching allocator reuses it only for work
    # queued after the kernel on the same stream
    table = _upload_table(desc, bounds, q.device)
    d_ptr = table.data_ptr()
    FLASH_SCHED.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        d_ptr, d_ptr + 6 * g * 4,
        g, p, b, s, h, h // kvh, hd, block_q, block_k, int(causal),
        int(window), *_strides(q, k, v, out),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _flash_dense_cuda(q, k, v, *, causal: bool, window: int):
    """Launch ``flash_dense`` on q (b, s, h, hd), k/v (b, s, kvh, hd) in
    place of their strides; returns a new (b, s, h, hd) tensor."""
    _check_kernel_inputs("flash_dense", q, k, v)
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    FLASH_DENSE.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, h // kvh, hd, int(causal), int(window),
        *_strides(q, k, v, out),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_attention_dense_plain(q, k, v, *, causal: bool = True,
                                window: int = 0):
    """The plain PyTorch version of the dense kernel: q, k, v (bh, s, hd)
    -> (bh, s, hd), fp32 masked softmax, on any device."""
    return flash_attention_sched_plain(q, k, v, causal=causal, window=window)


def flash_attention_dense_bshd(q, k, v, *, causal: bool = True,
                               window: int = 0):
    """Dense flash attention in the model layout: q (b, s, h, hd), k/v
    (b, s, kvh, hd) -> (b, s, h, hd).  A CUDA tensor launches
    ``flash_dense``; a CPU tensor takes the plain version."""
    dev = check_device(q, k, v)
    if dev.type == "cuda":
        return _flash_dense_cuda(q, k, v, causal=causal, window=window)
    b, s, h, hd = q.shape
    out = flash_attention_dense_plain(*broadcast_flatten(q, k, v),
                                      causal=causal, window=window)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         block_q: int = 512, block_k: int = 512):
    """Dense flash attention: q, k, v (bh, s, hd) -> (bh, s, hd).

    The reference's signature without ``interpret``.  ``block_q`` and
    ``block_k`` name the TPU kernel's blocking; the result does not depend
    on them (the card tiles by 128 x 128, the plain version does not tile).
    """
    out = flash_attention_dense_bshd(q.unsqueeze(2), k.unsqueeze(2),
                                     v.unsqueeze(2), causal=causal,
                                     window=window)
    return out.squeeze(2)


def flash_attention_sched_bshd(q, k, v, *,
                               schedule: Union[str, object] = "fac2",
                               kv_lens: Optional[Sequence[int]] = None,
                               causal: bool = True, window: int = 0,
                               block_q: int = 512, block_k: int = 512,
                               sched_p: int = 8, recorder=None,
                               loop_name: str = "flash_kv"):
    """Schedule-aware flash attention in the model layout:
    q (b, s, h, hd), k/v (b, s, kvh, hd) -> (b, s, h, hd).

    ``kv_lens`` is per lane (shape (b*h,), lane = batch * h + head).  The
    plan is made as in the reference; a CUDA tensor then launches the
    kernel with ``sched_p`` CTAs, a CPU tensor takes the plain version.
    """
    dev = check_device(q, k, v)
    b, s, h, hd = q.shape
    block_q = min(block_q, max(s, 8))
    block_k = min(block_k, max(s, 8))
    desc, plan = _plan_kv_descriptors(
        b * h, s, block_q, block_k, causal=causal, window=window,
        kv_lens=None if kv_lens is None else np.asarray(kv_lens),
        schedule=schedule, p=sched_p)
    if recorder is not None:
        recorder.add(plan.to_record(
            loop_name, instance=recorder.next_instance(loop_name)))
    if dev.type == "cuda":
        return _flash_sched_cuda(q, k, v, desc, descriptor_bounds(desc, plan),
                                 block_q=block_q, block_k=block_k,
                                 causal=causal, window=window)
    qf, kf, vf = broadcast_flatten(q, k, v)
    out = flash_attention_sched_plain(qf, kf, vf, kv_lens=kv_lens,
                                      causal=causal, window=window)
    return out.reshape(b, h, s, hd).permute(0, 2, 1, 3)


def flash_attention_sched_bhsd(q, k, v, *,
                               schedule: Union[str, object] = "fac2",
                               kv_lens: Optional[Sequence[int]] = None,
                               causal: bool = True, window: int = 0,
                               block_q: int = 512, block_k: int = 512,
                               sched_p: int = 8, recorder=None,
                               loop_name: str = "flash_kv"):
    """Schedule-aware flash attention: q, k, v (bh, s, hd) -> (bh, s, hd).

    The (lane, q block) group order is DLS-planned from per-group live-KV
    costs with ``schedule`` (any registry technique / ScheduleSpec).
    ``kv_lens`` gives each lane's valid KV prefix; columns at or beyond it
    are masked and dead KV blocks are never visited.  ``sched_p`` is the
    planner's worker count, and on the card the kernel's CTA count.
    ``recorder`` (a ``LoopRecorder``) receives the plan's telemetry.
    Output is bit-identical for every ``schedule``.
    """
    out = flash_attention_sched_bshd(
        q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), schedule=schedule,
        kv_lens=kv_lens, causal=causal, window=window, block_q=block_q,
        block_k=block_k, sched_p=sched_p, recorder=recorder,
        loop_name=loop_name)
    return out.squeeze(2)
