"""Flash-attention forward: the dense kernel, the schedule-aware kernel,
their plans and their plain versions.

Port of ``src/repro/kernels/flash_attention/flash_attention.py``.

Dense (``flash_attention_bhsd``, the reference's ``_flash_kernel``): on a
CUDA tensor ``csrc/flash_dense.cu`` runs one CTA per (lane, 128-row q tile)
with the kv blocks as a loop inside it, skipping those above the causal
diagonal or outside the sliding window; see the note at the top of that
file.  On a CPU tensor ``flash_attention_dense_plain`` (fp32 masked
softmax) computes the same function.

Dense backward (no Pallas kernel: the reference differentiates the
kernel's pure-JAX twin ``_attend_flash`` by autodiff): on a CUDA tensor
``flash_attention_dense_bshd`` runs ``_FlashDense``, an autograd Function
whose forward also asks ``flash_dense`` for each row's log-sum-exp and
whose backward launches ``csrc/flash_dense_bwd.cu`` (D = rowsum(dO o O),
then dK and dV, then dQ; TMA + wgmma at every head dim the forward
takes).  On a CPU tensor autograd differentiates the plain version;
``flash_attention_dense_bwd_plain`` computes the same gradients
explicitly, for the checks on the card.

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
heads in place through 4-D TMA tensor maps built from the strides.  Both
take any head dim that is a multiple of 8 up to 256 (the configs use 64,
80, 128 and 256): they compute at a padded width of 64, 128 or 256, TMA
filling the columns past the real head dim with zeros, except 80, whose
products run at its exact width on tiles of 128.

The tensor-core kernels ``flash_dense``, ``flash_sched`` and
``flash_dense_bwd`` take bf16 and fp16 (one instantiation of each tile
shape per type, the dtype code of ``SIMT_DTYPES`` in the launch).  The
reference casts q, k and v to fp32 inside its kernels and so takes any
float dtype.  fp16 keeps the reference's fp32 P and dS as two fp16 terms
each (hi + lo) and its backward's D from the fp32 output: with
``with_lse`` every fp16 dense forward, tensor-core or general, also writes
the output's rounding residual ``o_lo``, which the delta pass adds back
(see the note of ``csrc/flash_dense_bwd.cu``).
An fp32 call of either entry at a head dim that is a multiple of 8 up to
128, with strides and alignment TMA can describe, runs
``csrc/flash_f32.cu`` (route ``"tf32x3"``: TMA + wgmma .tf32 with every
product split into three TF32 products, fp32-accurate; kernels
``flash_dense_f32`` and ``flash_sched_f32``), and its backward
``csrc/flash_f32_bwd.cu``.  A dense fp32 call at head dims 136-256 (route
``"tf32x3_256"``) runs the same files on cluster pairs of CTAs that split
the head dim (``flash_dense_f32_256``, ``flash_f32_bwd256_*``).

A dense call whose head dim or strides the TMA boxes cannot describe
(route ``"simt"``), forward or backward, first copies its tensors to
TMA's layout (``_tma_pack``: contiguous, the head dim rounded up to a
multiple of 8, zeros past it; one launch of ``csrc/tma_pack.cu`` for all
of a call's tensors) and runs the copies' route on the tensor cores at
the softmax scale of the real head dim: the zero columns leave S, P V,
D = rowsum(dO o O) and the lse as they are, and the outputs come back
sliced to the real head dim.  The copy moves each input's bytes once.

The general kernels in plain fp32 FMA, ``csrc/flash_simt.cu`` (dense and
schedule-aware entries, the same plan walk) and ``csrc/flash_simt_bwd.cu``
(the backward; its delta pass serves every fp32 backward), take what is
left: the schedule-aware call at fp32 head dims 136-256
(``FLASH_SCHED_BY_ROUTE["tf32x3_256"]``) and at a head dim or strides TMA
cannot describe.  No route of the dense entry launches
``flash_dense_simt`` or the general backward's dkdv and dq passes; they
stay callable (``_flash_dense_simt_cuda``, ``_flash_simt_bwd_cuda``).
``_check_kernel_inputs`` picks the route from the dtype, the head dim and
the strides alone, and each entry's table (``FLASH_DENSE_BY_ROUTE``,
``FLASH_SCHED_BY_ROUTE``, ``FLASH_F32_BWD_BY_ROUTE``) names the kernel
that takes it; nothing falls back on a failure.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ...core.torch_sched import plan_tiles_for_kernel, worker_bounds
from ...device import check_device
from .._build import SIMT_DTYPES, Kernel
from .ref import attention_ref

#: padded head dims the flash kernels are instantiated for: they take any
#: multiple of 8 up to the largest, computing at the next of these (TMA
#: fills the columns past the real head dim with zeros; 80 runs its
#: products at their exact width)
PADDED_HEAD_DIMS = (64, 128, 256)
#: the largest head dim of the fp32 tensor-core kernels (route "tf32x3")
TF32X3_MAX_HEAD_DIM = 128

_c = ctypes
#: the tensor-core kernels of bf16 and fp16 (``csrc/flash_sched.cu``,
#: ``csrc/flash_dense.cu``; the dtype code of ``SIMT_DTYPES`` picks the
#: instantiation)
FLASH_SCHED = Kernel(
    "flash_sched", source="flash_sched", symbol="flash_sched_launch",
    argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 12 + [_c.c_longlong] * 12
    + [_c.c_float, _c.c_void_p])
FLASH_DENSE = Kernel(
    "flash_dense", source="flash_dense", symbol="flash_dense_launch",
    argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 8 + [_c.c_longlong] * 12
    + [_c.c_float, _c.c_void_p])
#: the backward (``csrc/flash_dense_bwd.cu``): D = rowsum(dO o O) and lse
#: log2(e), then dK and dV, then dQ; each launch counts on its own kernel
FLASH_DENSE_BWD_DELTA = Kernel(
    "flash_dense_bwd_delta", source="flash_dense_bwd",
    symbol="flash_dense_bwd_delta_launch",
    argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 6 + [_c.c_void_p])
FLASH_DENSE_BWD_DKDV = Kernel(
    "flash_dense_bwd_dkdv", source="flash_dense_bwd",
    symbol="flash_dense_bwd_dkdv_launch",
    argtypes=[_c.c_void_p] * 8 + [_c.c_int] * 9 + [_c.c_float, _c.c_void_p])
FLASH_DENSE_BWD_DQ = Kernel(
    "flash_dense_bwd_dq", source="flash_dense_bwd",
    symbol="flash_dense_bwd_dq_launch",
    argtypes=[_c.c_void_p] * 7 + [_c.c_int] * 9 + [_c.c_float, _c.c_void_p])
#: the backward's (b, h, s_pad) rows: s rounded up to its 128-row blocks
BWD_ROW_PAD = 128
#: the general kernels (``csrc/flash_simt.cu``, ``csrc/flash_simt_bwd.cu``):
#: every dtype of ``SIMT_DTYPES``, any head dim up to 256
FLASH_SCHED_SIMT = Kernel(
    "flash_sched_simt", source="flash_simt", symbol="flash_sched_simt_launch",
    argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 12 + [_c.c_longlong] * 12
    + [_c.c_float, _c.c_void_p])
FLASH_DENSE_SIMT = Kernel(
    "flash_dense_simt", source="flash_simt", symbol="flash_dense_simt_launch",
    argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 8 + [_c.c_longlong] * 12
    + [_c.c_float, _c.c_void_p])
FLASH_SIMT_BWD_DELTA = Kernel(
    "flash_simt_bwd_delta", source="flash_simt_bwd",
    symbol="flash_simt_bwd_delta_launch",
    argtypes=[_c.c_void_p] * 4 + [_c.c_int] * 5 + [_c.c_void_p])
FLASH_SIMT_BWD_DKDV = Kernel(
    "flash_simt_bwd_dkdv", source="flash_simt_bwd",
    symbol="flash_simt_bwd_dkdv_launch",
    argtypes=[_c.c_void_p] * 8 + [_c.c_int] * 8 + [_c.c_float, _c.c_void_p])
FLASH_SIMT_BWD_DQ = Kernel(
    "flash_simt_bwd_dq", source="flash_simt_bwd",
    symbol="flash_simt_bwd_dq_launch",
    argtypes=[_c.c_void_p] * 7 + [_c.c_int] * 8 + [_c.c_float, _c.c_void_p])
#: fp32 on the tensor cores, three TF32 products each (``csrc/flash_f32.cu``,
#: ``csrc/flash_f32_bwd.cu``); the backward's delta pass stays
#: ``flash_simt_bwd_delta``
_F32_DENSE_ARGS = ([_c.c_void_p] * 9 + [_c.c_int] * 8 + [_c.c_longlong] * 12
                   + [_c.c_float, _c.c_void_p])
FLASH_DENSE_F32 = Kernel(
    "flash_dense_f32", source="flash_f32", symbol="flash_f32_launch",
    argtypes=_F32_DENSE_ARGS)
#: the dense forward at head dims 136-256, each tile on a cluster pair of
#: CTAs that split the head dim
FLASH_DENSE_F32_256 = Kernel(
    "flash_dense_f32_256", source="flash_f32", symbol="flash_f32_256_launch",
    argtypes=_F32_DENSE_ARGS)
FLASH_SCHED_F32 = Kernel(
    "flash_sched_f32", source="flash_f32", symbol="flash_sched_f32_launch",
    argtypes=[_c.c_void_p] * 10 + [_c.c_int] * 12 + [_c.c_longlong] * 12
    + [_c.c_float, _c.c_void_p])
_F32_BWD_DKDV_ARGS = ([_c.c_void_p] * 9 + [_c.c_int] * 8
                      + [_c.c_float, _c.c_void_p])
_F32_BWD_DQ_ARGS = ([_c.c_void_p] * 8 + [_c.c_int] * 8
                    + [_c.c_float, _c.c_void_p])
FLASH_F32_BWD_DKDV = Kernel(
    "flash_f32_bwd_dkdv", source="flash_f32_bwd",
    symbol="flash_f32_bwd_dkdv_launch", argtypes=_F32_BWD_DKDV_ARGS)
FLASH_F32_BWD_DQ = Kernel(
    "flash_f32_bwd_dq", source="flash_f32_bwd",
    symbol="flash_f32_bwd_dq_launch", argtypes=_F32_BWD_DQ_ARGS)
#: the same passes at head dims 136-256, each tile on a cluster pair of
#: CTAs that split the head dim
FLASH_F32_BWD256_DKDV = Kernel(
    "flash_f32_bwd256_dkdv", source="flash_f32_bwd",
    symbol="flash_f32_bwd256_dkdv_launch", argtypes=_F32_BWD_DKDV_ARGS)
FLASH_F32_BWD256_DQ = Kernel(
    "flash_f32_bwd256_dq", source="flash_f32_bwd",
    symbol="flash_f32_bwd256_dq_launch", argtypes=_F32_BWD_DQ_ARGS)
#: the copy of a dense call's tensors to TMA's layout
#: (``csrc/tma_pack.cu``): up to TMA_PACK_MAX tensors of one dtype in one
#: launch, described by a table of TMA_PACK_FIELDS int64 each (source,
#: destination, b, s, heads, hd, the source's four strides)
TMA_PACK = Kernel(
    "tma_pack", source="tma_pack", symbol="tma_pack_launch",
    argtypes=[_c.c_void_p] + [_c.c_int] * 3 + [_c.c_void_p])
TMA_PACK_MAX, TMA_PACK_FIELDS = 6, 10
#: the transposed copies of the fp32 kernels hold s rounded up to this, a
#: multiple of their 32-column tiles (the launchers refuse another s_pad)
F32_COPY_PAD = 32
#: the dense and the schedule-aware kernel of each route
#: (:func:`flash_route`); the schedule-aware fp32 call at head dims 136-256
#: runs the general kernel; a dense call of route "simt" runs the route of
#: its copies in TMA's layout (:func:`_tma_pack`)
FLASH_DENSE_BY_ROUTE = {"wgmma": FLASH_DENSE, "tf32x3": FLASH_DENSE_F32,
                        "tf32x3_256": FLASH_DENSE_F32_256}
FLASH_SCHED_BY_ROUTE = {"wgmma": FLASH_SCHED, "tf32x3": FLASH_SCHED_F32,
                        "tf32x3_256": FLASH_SCHED_SIMT,
                        "simt": FLASH_SCHED_SIMT}
#: the (dkdv, dq) kernels of the backward's tensor-core fp32 routes: head
#: dims up to 128, and 136-256
FLASH_F32_BWD_BY_ROUTE = {
    "tf32x3": (FLASH_F32_BWD_DKDV, FLASH_F32_BWD_DQ),
    "tf32x3_256": (FLASH_F32_BWD256_DKDV, FLASH_F32_BWD256_DQ)}


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


def flash_route(dtype, hd: int, tma_ok: bool = True) -> str:
    """The kernel family a flash call of this dtype and head dim runs on
    the card, forward and backward: ``"wgmma"`` for bfloat16 and float16
    with a head dim that is a multiple of 8 and ``tma_ok`` (strides and
    alignment TMA can describe; ``flash_dense``, ``flash_sched``,
    ``flash_dense_bwd``); ``"tf32x3"`` for float32 likewise up to head dim
    128 and ``"tf32x3_256"`` at 136-256 (the fp32 tensor-core kernels;
    at 136-256 the schedule-aware entry's kernel is the general one);
    ``"simt"`` for every other float32 / bfloat16 / float16 call with a
    head dim up to 256: the schedule-aware entry runs the general kernel
    there, the dense entry, forward and backward, the route of the copies
    :func:`_tma_pack` makes (``flash_route(dtype, tma_head_dim(hd))``).
    Each entry's table names the kernel of a route.  Every forward writes
    the lse its backward reads:
    the natural log-sum-exp of the scaled, masked scores, +inf for a row
    with no live column (at 136-256 the pair's rank 0 writes it).  Raises
    for another dtype or head dim, which no kernel takes."""
    if dtype not in SIMT_DTYPES:
        raise TypeError(f"the flash kernels take float32, bfloat16 or "
                        f"float16, got {dtype}")
    if not 0 < hd <= PADDED_HEAD_DIMS[-1]:
        raise ValueError(f"the flash kernels take a head_dim up to "
                         f"{PADDED_HEAD_DIMS[-1]}, got {hd}")
    if hd % 8 or not tma_ok:
        return "simt"
    if dtype != torch.float32:
        return "wgmma"
    return "tf32x3" if hd <= TF32X3_MAX_HEAD_DIM else "tf32x3_256"


def _tma_ok(*tensors) -> bool:
    """Whether TMA can describe each (b, s, heads, hd) tensor: a contiguous
    last dim, strides that are multiples of 16 bytes, 16-byte aligned
    data."""
    return all(t.stride(3) == 1 and t.data_ptr() % 16 == 0
               and not any(st * t.element_size() % 16
                           for st in t.stride()[:3]) for t in tensors)


def tma_head_dim(hd: int) -> int:
    """The head dim of a copy to TMA's layout: ``hd`` rounded up to a
    multiple of 8."""
    return -(-hd // 8) * 8


def _tma_pack(hd_pad: int, *tensors):
    """Each (b, s, heads, hd) tensor as TMA can describe it at head dim
    ``hd_pad``: the tensor itself where :func:`_tma_ok` accepts it and its
    head dim is ``hd_pad``, else a fresh contiguous (b, s, heads, hd_pad)
    copy holding it in ``[..., :hd]`` and zeros past it.  On CUDA tensors
    one launch of ``tma_pack`` writes every copy (at most TMA_PACK_MAX, of
    one dtype); on CPU tensors :func:`tma_pack_plain` does."""
    todo = [i for i, x in enumerate(tensors)
            if x.shape[3] != hd_pad or not _tma_ok(x)]
    if not todo:
        return tensors
    srcs = [tensors[i] for i in todo]
    if srcs[0].device.type != "cuda":
        outs = tma_pack_plain(hd_pad, *srcs)
    else:
        outs = [x.new_empty(*x.shape[:3], hd_pad) for x in srcs]
        _tma_pack_launch(hd_pad, srcs, outs)
    result = list(tensors)
    for i, y in zip(todo, outs):
        result[i] = y
    return tuple(result)


def _tma_pack_launch(hd_pad: int, srcs, outs) -> None:
    """One ``tma_pack`` launch copying each (b, s, heads, hd) tensor of
    ``srcs`` into the fresh contiguous (b, s, heads, hd_pad) tensor of
    ``outs`` beside it; the launch table lives until the call returns,
    after the launch is queued."""
    if len(srcs) > TMA_PACK_MAX or any(
            x.dtype != srcs[0].dtype or x.device != srcs[0].device
            for x in srcs):
        raise ValueError(f"tma_pack takes at most {TMA_PACK_MAX} tensors "
                         f"of one dtype on one device")
    table = (_c.c_longlong * (TMA_PACK_FIELDS * len(srcs)))(*(
        v for x, y in zip(srcs, outs)
        for v in (x.data_ptr(), y.data_ptr(), *x.shape, *x.stride())))
    TMA_PACK.launch(_c.addressof(table), len(srcs), hd_pad,
                    srcs[0].element_size(),
                    torch.cuda.current_stream(srcs[0].device).cuda_stream)


def tma_pack_plain(hd_pad: int, *tensors):
    """The plain PyTorch version of ``tma_pack``: each (b, s, heads, hd)
    tensor copied into a fresh contiguous (b, s, heads, hd_pad) tensor,
    zeros past hd (a copy and a fill on any device)."""
    outs = []
    for x in tensors:
        y = x.new_empty(*x.shape[:3], hd_pad)
        y[..., :x.shape[3]].copy_(x)
        y[..., x.shape[3]:].zero_()
        outs.append(y)
    return outs


def _check_kernel_inputs(name: str, q, k, v) -> str:
    """Check q (b, s, h, hd), k/v (b, s, kvh, hd) and return the kernel
    family that takes them (:func:`flash_route`): a GQA layout and one
    dtype; the TMA kernels also need a contiguous last dim, strides that
    are multiples of 16 bytes and 16-byte aligned data."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape != (b, s, kvh, hd) or v.shape != k.shape or h % kvh:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"v {tuple(v.shape)} do not form a GQA layout")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes q, k and v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    return flash_route(q.dtype, hd, _tma_ok(q, k, v))


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
    """Launch the schedule-aware kernel of the inputs' route
    (``FLASH_SCHED_BY_ROUTE``) on q (b, s, h, hd), k/v (b, s, kvh, hd) in
    place of their strides; returns a new (b, s, h, hd) tensor."""
    kernel = FLASH_SCHED_BY_ROUTE[_check_kernel_inputs("flash_sched", q, k,
                                                       v)]
    if kernel is FLASH_SCHED_SIMT:
        return _flash_sched_simt_cuda(q, k, v, desc, bounds, block_q=block_q,
                                      block_k=block_k, causal=causal,
                                      window=window)
    out, table, ptrs, shape, tail = _sched_args(
        q, k, v, desc, bounds, block_q, block_k, causal, window)
    if kernel is FLASH_SCHED_F32:
        b, s, _, hd = q.shape
        kc, vt, s_pad = _f32_copies(b, s, k.shape[2], hd, q.device)
        kernel.launch(*ptrs, *_ptrs(*kc, *vt), s_pad, *shape, *tail)
    else:
        kernel.launch(*ptrs, *shape, SIMT_DTYPES[q.dtype], *tail)
    return out


def _flash_sched_simt_cuda(q, k, v, desc, bounds, *, block_q: int,
                           block_k: int, causal: bool, window: int):
    """The general schedule-aware kernel on q (b, s, h, hd), k/v
    (b, s, kvh, hd) of any dtype of ``SIMT_DTYPES``, as
    :func:`_flash_sched_cuda` returns."""
    q, k, v = _unit_stride(q, k, v)
    out, table, ptrs, shape, tail = _sched_args(
        q, k, v, desc, bounds, block_q, block_k, causal, window)
    FLASH_SCHED_SIMT.launch(*ptrs, *shape, SIMT_DTYPES[q.dtype], *tail)
    return out


def _sched_args(q, k, v, desc, bounds, block_q, block_k, causal, window):
    """The schedule-aware kernels' output, the descriptor table on the card
    and their launch arguments: pointers, shape and the strides, scale and
    stream.  The caller keeps the table bound until the launch is queued:
    the caching allocator then reuses it only for work queued after the
    kernel on the same stream."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    g = int(desc[0].shape[0])
    p = int(bounds.shape[0]) - 1
    table = _upload_table(desc, bounds, q.device)
    d_ptr = table.data_ptr()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            d_ptr, d_ptr + 6 * g * 4)
    shape = (g, p, b, s, h, h // kvh, hd, block_q, block_k, int(causal),
             int(window))
    tail = (*_strides(q, k, v, out), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    return out, table, ptrs, shape, tail


def _f32_copies(b: int, s: int, kvh: int, hd: int, device):
    """Scratch of the fp32 forwards' split copies, K hi / lo
    (2, b, s, kvh, hd) and V^T hi / lo (2, b, kvh, hd, s_pad), and s_pad.
    The caller keeps both bound until the launch that writes them is
    queued, as the descriptor table (:func:`_sched_args`)."""
    s_pad = -(-s // F32_COPY_PAD) * F32_COPY_PAD
    kc = torch.empty((2, b, s, kvh, hd), dtype=torch.float32, device=device)
    vt = torch.empty((2, b, kvh, hd, s_pad), dtype=torch.float32,
                     device=device)
    return kc, vt, s_pad


def _ptrs(*tensors) -> tuple[int, ...]:
    """The tensors' data pointers, in order."""
    return tuple(t.data_ptr() for t in tensors)


def _flash_dense_cuda(q, k, v, *, causal: bool, window: int,
                      with_lse: bool = False):
    """Launch the dense kernel of the inputs' route on q (b, s, h, hd),
    k/v (b, s, kvh, hd) in place of their strides; returns a new
    (b, s, h, hd) tensor, and with ``with_lse`` (out, lse, o_lo): each
    row's log-sum-exp (b, h, s) fp32 and, in fp16, the output's rounding
    residual out_fp32 - out (else None), the residuals that
    :func:`_flash_dense_bwd_cuda` takes as they come.  The output is the
    same bits either way.  Where the route is "simt" (a head dim or
    strides TMA cannot describe), q, k and v are first copied to TMA's
    layout (:func:`_tma_pack`) and the copies' route runs; the output is
    then a view of the copies' output sliced to ``hd``, and o_lo that
    output's residual at the copies' head dim."""
    hd = q.shape[3]
    if _check_kernel_inputs("flash_dense", q, k, v) == "simt":
        q, k, v = _tma_pack(tma_head_dim(hd), q, k, v)
    return _flash_dense_packed(q, k, v, hd, causal=causal, window=window,
                               with_lse=with_lse)


def _flash_dense_packed(q, k, v, hd: int, *, causal: bool, window: int,
                        with_lse: bool = False):
    """:func:`_flash_dense_cuda` on q (b, s, h, hd_pad), k/v
    (b, s, kvh, hd_pad) that TMA can describe and whose columns past the
    real head dim ``hd`` are zero: the kernel of their route at the
    softmax scale 1 / sqrt(hd), the output sliced to ``hd``."""
    route = _check_kernel_inputs("flash_dense", q, k, v)
    b, s, h, hd_pad = q.shape
    kvh = k.shape[2]
    kernel = FLASH_DENSE_BY_ROUTE[route]
    out, res, ptrs, shape, tail = _dense_args(q, k, v, causal, window,
                                              with_lse, hd)
    if route == "wgmma":
        kernel.launch(*ptrs, *shape, SIMT_DTYPES[q.dtype], *tail)
    else:
        kc, vt, s_pad = _f32_copies(b, s, kvh, hd_pad, q.device)
        kernel.launch(*ptrs[:4], ptrs[5], *_ptrs(*kc, *vt), s_pad, *shape,
                      *tail)
    if hd != hd_pad:
        out = out[..., :hd]
    return (out, *res) if with_lse else out


def _flash_dense_simt_cuda(q, k, v, *, causal: bool, window: int,
                           with_lse: bool = False):
    """The general dense kernel on q (b, s, h, hd), k/v (b, s, kvh, hd) of
    any dtype of ``SIMT_DTYPES``, as :func:`_flash_dense_cuda` returns."""
    q, k, v = _unit_stride(q, k, v)
    out, res, ptrs, shape, tail = _dense_args(q, k, v, causal, window,
                                              with_lse, q.shape[3])
    FLASH_DENSE_SIMT.launch(*ptrs, *shape, SIMT_DTYPES[q.dtype], *tail)
    return (out, *res) if with_lse else out


def _dense_args(q, k, v, causal, window, with_lse, hd):
    """The dense kernels' output, residuals (lse, o_lo): each None where
    not written, o_lo written in fp16 only, and their launch arguments:
    pointers (q, k, v, out, o_lo, lse), shape and the strides, the scale
    of the real head dim ``hd`` and the stream."""
    b, s, h, width = q.shape
    kvh = k.shape[2]
    out = torch.empty((b, s, h, width), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    o_lo = (torch.empty_like(out)
            if with_lse and q.dtype == torch.float16 else None)
    ptrs = _ptrs(q, k, v, out) + tuple(
        None if x is None else x.data_ptr() for x in (o_lo, lse))
    shape = (b, s, h, h // kvh, width, int(causal), int(window))
    tail = (*_strides(q, k, v, out), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    return out, (lse, o_lo), ptrs, shape, tail


def _flash_dense_bwd_cuda(q, k, v, o, do, lse, o_lo=None, *, causal: bool,
                          window: int):
    """Launch the three backward kernels on the forward's q (b, s, h, hd),
    k/v (b, s, kvh, hd), output o, its gradient do and the residuals of
    :func:`_flash_dense_cuda`, lse (b, h, s) and o_lo (fp16 only, at hd or
    at the forward's copies' head dim); returns (dq, dk, dv) in the
    inputs' shapes and dtype.  q, k, v, o, do and o_lo are first made
    contiguous in TMA's layout (:func:`_tma_pack`, then ``.contiguous()``),
    so every call runs the route of the packed tensors:
    ``flash_dense_bwd`` ("wgmma") or ``flash_f32_bwd`` ("tf32x3",
    "tf32x3_256")."""
    _check_kernel_inputs("flash_dense", q, k, v)
    if (o_lo is None) == (q.dtype == torch.float16):
        raise ValueError(f"the backward of {q.dtype} takes "
                         + ("the forward's o_lo" if o_lo is None
                            else "no o_lo"))
    hd = q.shape[3]
    packed = [x.contiguous() for x in _tma_pack(
        tma_head_dim(hd), q, k, v, o, do.to(q.dtype),
        *(() if o_lo is None else (o_lo,)))]
    return _flash_dense_bwd_packed(*packed[:5], lse.contiguous(),
                                   packed[5] if len(packed) > 5 else None,
                                   hd, causal=causal, window=window)


def _flash_dense_bwd_packed(q, k, v, o, do, lse, o_lo, hd: int, *,
                            causal: bool, window: int):
    """:func:`_flash_dense_bwd_cuda` on contiguous q (b, s, h, hd_pad), k/v
    (b, s, kvh, hd_pad), o, do and o_lo (or None) at a multiple of 8 whose
    columns past the real head dim ``hd`` are zero, and lse (b, h, s): the
    backward kernels of their route at the softmax scale 1 / sqrt(hd),
    (dq, dk, dv) sliced to ``hd``."""
    route = _check_kernel_inputs("flash_dense", q, k, v)
    b, s, h, hd_pad = q.shape
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route != "wgmma":
        grads = _flash_f32_bwd_cuda(q, k, v, o, do, lse, causal=causal,
                                    window=window, stream=stream,
                                    kernels=FLASH_F32_BWD_BY_ROUTE[route],
                                    scale=scale)
    else:
        s_pad = -(-s // BWD_ROW_PAD) * BWD_ROW_PAD
        # lse log2(e) and D, (b, h, s_pad): +inf and 0 past s
        lse2, delta = torch.empty((2, b, h, s_pad), dtype=torch.float32,
                                  device=q.device).unbind(0)
        code = SIMT_DTYPES[q.dtype]
        FLASH_DENSE_BWD_DELTA.launch(
            o.data_ptr(), None if o_lo is None else o_lo.data_ptr(),
            do.data_ptr(), lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
            b, s, s_pad, h, hd_pad, code, stream)
        grads = tuple(torch.empty_like(x) for x in (q, k, v))
        shape = (b, s, s_pad, h, h // kvh, hd_pad, int(causal), int(window),
                 code, scale, stream)
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse2.data_ptr(), delta.data_ptr())
        FLASH_DENSE_BWD_DKDV.launch(*ins, grads[1].data_ptr(),
                                    grads[2].data_ptr(), *shape)
        FLASH_DENSE_BWD_DQ.launch(*ins, grads[0].data_ptr(), *shape)
    if hd != hd_pad:
        grads = tuple(g[..., :hd] for g in grads)
    return grads


def _flash_simt_bwd_cuda(q, k, v, o, do, lse, *, causal: bool, window: int,
                         stream, o_lo=None):
    """The general backward on contiguous q (b, s, h, hd), k/v
    (b, s, kvh, hd), o, do, the forward's lse (b, h, s) and o_lo (or
    None): D, then dK and dV, then dQ."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    code = SIMT_DTYPES[q.dtype]
    delta = _simt_delta(o, do, stream, o_lo)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    shape = (b, s, h, h // kvh, hd, int(causal), int(window), code,
             1.0 / math.sqrt(hd), stream)
    FLASH_SIMT_BWD_DKDV.launch(*ins, dk.data_ptr(), dv.data_ptr(), *shape)
    FLASH_SIMT_BWD_DQ.launch(*ins, dq.data_ptr(), *shape)
    return dq, dk, dv


def _simt_delta(o, do, stream, o_lo=None):
    """D = rowsum(dO o (O + o_lo)), (b, h, s) fp32, of contiguous o, do
    (b, s, h, hd) and o's rounding residual o_lo (or None) by the general
    delta pass."""
    b, s, h, hd = o.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=o.device)
    FLASH_SIMT_BWD_DELTA.launch(o.data_ptr(), None if o_lo is None
                                else o_lo.data_ptr(), do.data_ptr(),
                                delta.data_ptr(), b, s, h, hd,
                                SIMT_DTYPES[o.dtype], stream)
    return delta


def _flash_f32_bwd_cuda(q, k, v, o, do, lse, *, causal: bool, window: int,
                        stream, kernels, scale: float):
    """The fp32 backward on the tensor cores on contiguous q (b, s, h, hd),
    k/v (b, s, kvh, hd), o, do and the forward's lse (b, h, s) with
    ``kernels`` (dkdv, dq) of :data:`FLASH_F32_BWD_BY_ROUTE` at the
    softmax scale ``scale``: D (the general delta pass), then dK and dV,
    then dQ.  Each pass first writes
    the split copies of its stage operands into one scratch buffer, which
    the dq pass reuses after the dkdv pass on the same stream."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    dkdv_kernel, dq_kernel = kernels
    delta = _simt_delta(o, do, stream)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    s_pad = -(-s // F32_COPY_PAD) * F32_COPY_PAD
    # dkdv: Q and dO hi / lo in both layouts; dq needs less (K and V).
    # 1.07 GB at qwen3-4b's training shape (2 x 4096, 32 heads, hd 128),
    # 335 MB at recurrentgemma-2b's local attention (1 x 4096, 10 heads,
    # hd 256)
    ws = torch.empty(4 * b * h * hd * (s + s_pad), dtype=torch.float32,
                     device=q.device)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    shape = (b, s, h, h // kvh, hd, int(causal), int(window), scale, stream)
    dkdv_kernel.launch(*ins, dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
                       s_pad, *shape)
    dq_kernel.launch(*ins, dq.data_ptr(), ws.data_ptr(), s_pad, *shape)
    return dq, dk, dv


def _unit_stride(*tensors):
    """The tensors with their last dim contiguous, as the general kernels
    read them (a copy only where it is not)."""
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in tensors)


class _FlashDense(torch.autograd.Function):
    """The dense kernel under autograd: the forward launches the kernel of
    the inputs' route (of their copies in TMA's layout where the route is
    "simt") and, when a gradient is wanted, keeps q, k, v, the output and
    the rows' log-sum-exp; the backward launches that route's backward
    kernels on q, k, v, the output and its gradient in TMA's layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        grad = any(ctx.needs_input_grad[:3])
        if not grad:
            return _flash_dense_cuda(q, k, v, causal=causal, window=window)
        out, lse, o_lo = _flash_dense_cuda(q, k, v, causal=causal,
                                           window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, o_lo)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, o_lo = ctx.saved_tensors
        dq, dk, dv = _flash_dense_bwd_cuda(q, k, v, out, do, lse, o_lo,
                                           causal=ctx.causal,
                                           window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_dense_plain(q, k, v, *, causal: bool = True,
                                window: int = 0):
    """The plain PyTorch version of the dense kernel: q, k, v (bh, s, hd)
    -> (bh, s, hd), fp32 masked softmax, on any device."""
    return flash_attention_sched_plain(q, k, v, causal=causal, window=window)


def flash_attention_dense_bwd_plain(q, k, v, do, *, causal: bool = True,
                                    window: int = 0):
    """The plain version of the backward: (dq, dk, dv) of the dense
    function at q (b, s, h, hd), k/v (b, s, kvh, hd) for the output
    gradient do (b, s, h, hd), by ``torch.autograd.grad`` through
    ``flash_attention_dense_plain`` in fp32, 32 lanes at a time (bounding
    the fp32 (lanes, s, s) scores); fp32 results on any device."""
    lane_chunk = 32
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qf, kf, vf = (x.detach().float().contiguous()
                  for x in broadcast_flatten(q, k, v))
    dof = do.detach().float().permute(0, 2, 1, 3).reshape(b * h, s, hd)
    grads = [torch.empty_like(qf) for _ in range(3)]
    for a in range(0, b * h, lane_chunk):
        z = slice(a, min(a + lane_chunk, b * h))
        leaves = [x[z].requires_grad_(True) for x in (qf, kf, vf)]
        with torch.enable_grad():
            out = flash_attention_dense_plain(*leaves, causal=causal,
                                              window=window)
            got = torch.autograd.grad(out, leaves, dof[z])
        for dst, g in zip(grads, got):
            dst[z] = g
    dq, dk, dv = (g.reshape(b, h, s, hd).permute(0, 2, 1, 3) for g in grads)
    # the GQA group's lanes share one KV head: their gradients sum
    dk, dv = (g.reshape(b, s, kvh, h // kvh, hd).sum(3) for g in (dk, dv))
    return dq, dk, dv


def flash_attention_dense_bshd(q, k, v, *, causal: bool = True,
                               window: int = 0):
    """Dense flash attention in the model layout: q (b, s, h, hd), k/v
    (b, s, kvh, hd) -> (b, s, h, hd).  A CUDA tensor goes through
    ``_FlashDense`` (``flash_dense``, and ``flash_dense_bwd`` for its
    gradient); a CPU tensor takes the plain version, which autograd
    differentiates."""
    dev = check_device(q, k, v)
    if dev.type == "cuda":
        return _FlashDense.apply(q, k, v, causal, window)
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
