"""Grouped (expert-tile) matmul with a DLS-planned work list: the kernel and
its plain version.

Port of ``src/repro/kernels/grouped_matmul/grouped_matmul.py``.  The MoE
expert FFN is a ragged batch of matmuls: expert e owns rows[e] tokens.  The
work list is a 1-D list of row tiles, each multiplied by its expert's
(d, f) weight; the tile order comes from the DLS planner
(``repro_torch.balance.moe.plan_tiles``), so that a split of the list
across ``p`` workers gives each near-equal work.

On a CUDA tensor the list drives ``csrc/gmm.cu``: a persistent kernel with
``p`` CTAs, CTA ``w`` walking its plan share in order and then its
round-robin part of the dead tiles, fed by TMA and computed with wgmma;
see the note at the top of that file.
On a CPU tensor ``grouped_matmul_tiles_plain`` computes the same function.
Tiles are independent, so the output is bit-identical for every order.

The backward of the expert-row product Y[e] = X[e] W[e] (no Pallas kernel:
the reference differentiates its einsums by autodiff), for training the
ragged MoE: ``grouped_matmul_bwd`` computes dX = dY W^T with ``gmm`` itself,
the weights read K-major in place (``gmm_cuda(..., transpose_w=True)``),
and dW[e] = X[e]^T dY[e] with ``gmm_dw`` (``csrc/gmm.cu``: one CTA per
(expert, dW tile) at a time, persistent, the rows summed in ascending
order: no split-k, no atomics).  On a CPU tensor
``grouped_matmul_bwd_plain`` computes both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import check_device
from .._build import Kernel
from .ref import grouped_matmul_ref

#: what the CUDA kernel takes: block_rows and f multiples of its 128-row,
#: 128-column output blocks (256 columns where f allows), d a multiple of 32
#: (its 64-deep stages are zero-filled past d)
KERNEL_BLOCK_ROWS, KERNEL_BLOCK_COLS, KERNEL_BLOCK_D = 128, 128, 32

_c = ctypes
GMM = Kernel("gmm", source="gmm", symbol="gmm_launch",
             argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 8 + [_c.c_void_p])
GMM_DW = Kernel("gmm_dw", source="gmm", symbol="gmm_dw_launch",
                argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 5 + [_c.c_void_p])


def span_bounds(n: int, p: int) -> np.ndarray:
    """(p + 1,) offsets splitting ``n`` steps into ``p`` contiguous spans
    (the identity order's split)."""
    return np.asarray([(w * n) // p for w in range(p + 1)], np.int32)


def grouped_matmul_tiles_plain(x_tiles, weights, tile_expert):
    """The plain PyTorch version: x_tiles (T, bm, d), weights (E, d, f),
    tile_expert (T,) -> (T, bm, f), fp32 products cast to the input type,
    on any device (the oracle of ``ref.py``)."""
    return grouped_matmul_ref(x_tiles, weights, tile_expert)


def gmm_cuda(x_tiles, weights, tile_expert, order, bounds, n_span: int, *,
             transpose_w: bool = False):
    """Launch ``gmm``: step i of ``order`` multiplies x tile ``order[i]`` by
    expert ``tile_expert[order[i]]`` into output tile ``order[i]``.

    ``bounds`` (p + 1,) gives each CTA's live steps ``[b[w], b[w+1])`` of
    the first ``n_span`` steps; steps from ``n_span`` on are dealt
    round-robin.  Returns a new (T, bm, f) tensor; with ``transpose_w``,
    x_tiles is (T, bm, f), each tile is multiplied by its expert's
    weights transposed (read in place) and the result is (T, bm, d).
    """
    t, bm, k = x_tiles.shape
    e, d, f = weights.shape
    k_w, n = (f, d) if transpose_w else (d, f)
    if k_w != k or tuple(tile_expert.shape) != (t,):
        raise ValueError(f"x_tiles {tuple(x_tiles.shape)}, weights "
                         f"{tuple(weights.shape)} and tile_expert "
                         f"{tuple(tile_expert.shape)} do not agree")
    if x_tiles.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"gmm takes bfloat16 x and weights, got "
                        f"{x_tiles.dtype}, {weights.dtype}")
    if bm % KERNEL_BLOCK_ROWS or n % KERNEL_BLOCK_COLS or k % KERNEL_BLOCK_D:
        depth, width = ("f", "d") if transpose_w else ("d", "f")
        raise ValueError(
            f"gmm needs block_rows % {KERNEL_BLOCK_ROWS} == 0, {width} % "
            f"{KERNEL_BLOCK_COLS} == 0 and {depth} % {KERNEL_BLOCK_D} == 0; "
            f"got bm={bm}, d={d}, f={f}")
    for name, x in (("x_tiles", x_tiles), ("weights", weights)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    order = np.asarray(order, np.int32).reshape(-1)
    if not np.array_equal(np.sort(order), np.arange(t)) or not 0 <= n_span <= t:
        raise ValueError("order must be a permutation of the T tiles and "
                         "n_span lie in [0, T]")
    host = np.concatenate([order, np.asarray(bounds, np.int32)])
    out = torch.empty((t, bm, n), dtype=x_tiles.dtype, device=x_tiles.device)
    # freed when this returns: the caching allocator reuses it only for work
    # queued after the kernel on the same stream.  Copied from pinned memory
    # without blocking, so the host does not wait for the stream to drain.
    table = torch.from_numpy(host).pin_memory().to(x_tiles.device,
                                                   non_blocking=True)
    te = tile_expert.to(device=x_tiles.device, dtype=torch.int32).contiguous()
    ptr = table.data_ptr()
    GMM.launch(x_tiles.data_ptr(), weights.data_ptr(), out.data_ptr(),
               ptr, te.data_ptr(), ptr + 4 * t, len(bounds) - 1, n_span, t,
               bm, d, f, e, int(transpose_w),
               torch.cuda.current_stream(x_tiles.device).cuda_stream)
    return out


def gmm_dw_cuda(xe, dy, *, sched_p: int):
    """Launch ``gmm_dw``: dW[e] = xe[e]^T dy[e] for xe (E, R, d) and dy
    (E, R, f), bfloat16, fp32 sums over the R rows in ascending order, on
    ``sched_p`` persistent CTAs.  Returns a new (E, d, f) bfloat16 tensor."""
    e, r, d = xe.shape
    if dy.dim() != 3 or dy.shape[:2] != xe.shape[:2]:
        raise ValueError(f"xe {tuple(xe.shape)} and dy {tuple(dy.shape)} do "
                         "not agree")
    f = dy.shape[2]
    if xe.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16:
        raise TypeError(f"gmm_dw takes bfloat16 xe and dy, got {xe.dtype}, "
                        f"{dy.dtype}")
    if d % KERNEL_BLOCK_ROWS or f % KERNEL_BLOCK_COLS or r == 0:
        raise ValueError(f"gmm_dw needs d % {KERNEL_BLOCK_ROWS} == 0 and f % "
                         f"{KERNEL_BLOCK_COLS} == 0; got d={d}, f={f}, R={r}")
    for name, x in (("xe", xe), ("dy", dy)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    dw = torch.empty((e, d, f), dtype=xe.dtype, device=xe.device)
    GMM_DW.launch(xe.data_ptr(), dy.data_ptr(), dw.data_ptr(), e, r, d, f,
                  sched_p, torch.cuda.current_stream(xe.device).cuda_stream)
    return dw


def grouped_matmul_bwd_plain(xe, weights, dy, *, need_dx: bool = True,
                             need_dw: bool = True):
    """The plain version of the backward of xe (E, R, d) @ weights (E, d, f)
    for the output gradient dy (E, R, f): (dx, dw), fp32 products cast to
    the types of xe and weights, None where not asked for; any device."""
    dx = dw = None
    if need_dx:
        dx = torch.einsum("erf,edf->erd", dy.float(),
                          weights.float()).to(xe.dtype)
    if need_dw:
        dw = torch.einsum("erd,erf->edf", xe.float(),
                          dy.float()).to(weights.dtype)
    return dx, dw


def grouped_matmul_bwd(xe, weights, dy, *, need_dx: bool = True,
                       need_dw: bool = True, sched_p: int = 8):
    """(dx, dw) of xe (E, R, d) @ weights (E, d, f) for dy (E, R, f), None
    where not asked for.  On the card dx is ``gmm`` over the dy tiles of
    ``KERNEL_BLOCK_ROWS`` rows in the identity order, split into ``sched_p``
    spans, with the weights read transposed in place, and dw is ``gmm_dw``
    on ``sched_p`` CTAs; on the CPU the plain version."""
    dev = check_device(xe, weights, dy)
    if dev.type == "cpu":
        return grouped_matmul_bwd_plain(xe, weights, dy, need_dx=need_dx,
                                        need_dw=need_dw)
    e, r, _ = xe.shape
    dy = dy.contiguous()
    dx = dw = None
    if need_dx:
        bm = KERNEL_BLOCK_ROWS
        if r % bm:
            raise ValueError(f"R={r} is not a multiple of the kernel's "
                             f"{bm}-row tile")
        t = e * (r // bm)
        tile_expert = torch.arange(t, dtype=torch.int32,
                                   device=dev) // (r // bm)
        dx = gmm_cuda(dy.reshape(t, bm, dy.shape[2]), weights,
                      tile_expert, np.arange(t, dtype=np.int32),
                      span_bounds(t, sched_p), t,
                      transpose_w=True).reshape(e, r, weights.shape[1])
    if need_dw:
        dw = gmm_dw_cuda(xe.contiguous(), dy, sched_p=sched_p)
    return dx, dw


def grouped_matmul_tiles(x_tiles, weights, tile_expert, *, sched_p: int = 8):
    """x_tiles: (T, bm, d) row tiles; weights: (E, d, f);
    tile_expert: (T,) int32 expert id per tile -> out (T, bm, f).

    The tile order is the caller's.  On the card the T tiles are split
    into ``sched_p`` contiguous spans, one per CTA.
    """
    dev = check_device(x_tiles, weights)
    if dev.type == "cpu":
        return grouped_matmul_tiles_plain(x_tiles, weights, tile_expert)
    t = x_tiles.shape[0]
    te = torch.as_tensor(tile_expert, device=dev)
    if te.numel() and not 0 <= int(te.min()) <= int(te.max()) < weights.shape[0]:
        raise ValueError(f"tile_expert must lie in [0, {weights.shape[0]})")
    return gmm_cuda(x_tiles, weights, te, np.arange(t, dtype=np.int32),
                    span_bounds(t, sched_p), t)

