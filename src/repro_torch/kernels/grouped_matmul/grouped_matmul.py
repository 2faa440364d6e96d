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
ragged MoE: ``grouped_matmul_bwd`` computes dX = dY W^T with ``gmm_dx`` and
dW[e] = X[e]^T dY[e] with ``gmm_dw`` (both in ``csrc/gmm.cu``, persistent,
no split-k, no atomics).  dX needs no plan, so ``gmm_dx`` walks an
expert-major raster: the 128-row tiles that share one (expert, 256-column)
weight panel run at once on neighbouring CTAs, which read the panel from
device memory once and from L2 after that, the weights read K-major in
place.  ``gmm_dw`` runs one CTA per (expert, dW tile) at a time, the rows
summed in ascending order.  On a CPU tensor ``grouped_matmul_bwd_plain``
computes both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...device import check_device
from .._build import Kernel
from .ref import grouped_matmul_ref

#: what the CUDA kernels take: rows and output widths multiples of their
#: 128-row, 128-column output blocks (256 columns where the width allows),
#: the reduction depth a multiple of 32 (64-deep stages are zero-filled
#: past it); gmm: block_rows, f and d; gmm_dx: R, d and f
KERNEL_BLOCK_ROWS, KERNEL_BLOCK_COLS, KERNEL_BLOCK_D = 128, 128, 32

_c = ctypes
GMM = Kernel("gmm", source="gmm", symbol="gmm_launch",
             argtypes=[_c.c_void_p] * 6 + [_c.c_int] * 7 + [_c.c_void_p])
GMM_DX = Kernel("gmm_dx", source="gmm", symbol="gmm_dx_launch",
                argtypes=[_c.c_void_p] * 3 + [_c.c_int] * 5 + [_c.c_void_p])
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


def gmm_cuda(x_tiles, weights, tile_expert, order, bounds, n_span: int):
    """Launch ``gmm``: step i of ``order`` multiplies x tile ``order[i]`` by
    expert ``tile_expert[order[i]]`` into output tile ``order[i]``.

    ``bounds`` (p + 1,) gives each CTA's live steps ``[b[w], b[w+1])`` of
    the first ``n_span`` steps; steps from ``n_span`` on are dealt
    round-robin.  Returns a new (T, bm, f) tensor.
    """
    t, bm, k = x_tiles.shape
    e, d, f = weights.shape
    if d != k or tuple(tile_expert.shape) != (t,):
        raise ValueError(f"x_tiles {tuple(x_tiles.shape)}, weights "
                         f"{tuple(weights.shape)} and tile_expert "
                         f"{tuple(tile_expert.shape)} do not agree")
    if x_tiles.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"gmm takes bfloat16 x and weights, got "
                        f"{x_tiles.dtype}, {weights.dtype}")
    if bm % KERNEL_BLOCK_ROWS or f % KERNEL_BLOCK_COLS or d % KERNEL_BLOCK_D:
        raise ValueError(
            f"gmm needs block_rows % {KERNEL_BLOCK_ROWS} == 0, f % "
            f"{KERNEL_BLOCK_COLS} == 0 and d % {KERNEL_BLOCK_D} == 0; "
            f"got bm={bm}, d={d}, f={f}")
    _check_operands(x_tiles=x_tiles, weights=weights)
    order = np.asarray(order, np.int32).reshape(-1)
    if not np.array_equal(np.sort(order), np.arange(t)) or not 0 <= n_span <= t:
        raise ValueError("order must be a permutation of the T tiles and "
                         "n_span lie in [0, T]")
    host = np.concatenate([order, np.asarray(bounds, np.int32)])
    out = torch.empty((t, bm, f), dtype=x_tiles.dtype, device=x_tiles.device)
    # freed when this returns: the caching allocator reuses it only for work
    # queued after the kernel on the same stream.  Copied from pinned memory
    # without blocking, so the host does not wait for the stream to drain.
    table = torch.from_numpy(host).pin_memory().to(x_tiles.device,
                                                   non_blocking=True)
    te = tile_expert.to(device=x_tiles.device, dtype=torch.int32).contiguous()
    ptr = table.data_ptr()
    GMM.launch(x_tiles.data_ptr(), weights.data_ptr(), out.data_ptr(),
               ptr, te.data_ptr(), ptr + 4 * t, len(bounds) - 1, n_span, t,
               bm, d, f, e,
               torch.cuda.current_stream(x_tiles.device).cuda_stream)
    return out


def _check_operands(**tensors) -> None:
    for name, x in tensors.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def gmm_dx_cuda(dy, weights, *, sched_p: int):
    """Launch ``gmm_dx``: dX[e] = dy[e] weights[e]^T for dy (E, R, f) and
    weights (E, d, f), bfloat16, read in place, fp32 sums over f, on
    ``sched_p`` persistent CTAs over the expert-major units.  Returns a new
    (E, R, d) bfloat16 tensor."""
    if dy.dim() != 3 or weights.dim() != 3:
        raise ValueError(f"dy {tuple(dy.shape)} and weights "
                         f"{tuple(weights.shape)} must be 3-D")
    e, r, f = dy.shape
    if weights.shape[0] != e or weights.shape[2] != f:
        raise ValueError(f"dy {tuple(dy.shape)} and weights "
                         f"{tuple(weights.shape)} do not agree")
    d = weights.shape[1]
    if dy.dtype != torch.bfloat16 or weights.dtype != torch.bfloat16:
        raise TypeError(f"gmm_dx takes bfloat16 dy and weights, got "
                        f"{dy.dtype}, {weights.dtype}")
    if (r == 0 or r % KERNEL_BLOCK_ROWS or d % KERNEL_BLOCK_COLS
            or f % KERNEL_BLOCK_D):
        raise ValueError(
            f"gmm_dx needs R % {KERNEL_BLOCK_ROWS} == 0, d % "
            f"{KERNEL_BLOCK_COLS} == 0 and f % {KERNEL_BLOCK_D} == 0; got "
            f"R={r}, d={d}, f={f}")
    _check_operands(dy=dy, weights=weights)
    dx = torch.empty((e, r, d), dtype=dy.dtype, device=dy.device)
    GMM_DX.launch(dy.data_ptr(), weights.data_ptr(), dx.data_ptr(), e, r, d,
                  f, sched_p, torch.cuda.current_stream(dy.device).cuda_stream)
    return dx


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
    _check_operands(xe=xe, dy=dy)
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
    where not asked for.  On the card dx is ``gmm_dx`` and dw ``gmm_dw``,
    each on ``sched_p`` persistent CTAs; on the CPU the plain version."""
    dev = check_device(xe, weights, dy)
    if dev.type == "cpu":
        return grouped_matmul_bwd_plain(xe, weights, dy, need_dx=need_dx,
                                        need_dw=need_dw)
    dy = dy.contiguous()
    dx = gmm_dx_cuda(dy, weights, sched_p=sched_p) if need_dx else None
    dw = gmm_dw_cuda(xe.contiguous(), dy, sched_p=sched_p) if need_dw else None
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

